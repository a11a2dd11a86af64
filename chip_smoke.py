#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nobs_whisper_torch``) on one
NVIDIA card, at the full width and depth of large-v3-turbo with weights
made from a seed.

Run from the repo root: ``python3 chip_smoke.py`` (one card, no
arguments). Phases; any failure exits non-zero before the result line:

1. card and build: ``nvidia-smi`` name and power limit, torch/CUDA
   versions, one ``nvcc`` per kernel source started together, with the
   ``-Xptxas -v`` summary;
2. kernels against their plain PyTorch versions at turbo width (K1 at
   B=2, T=1536, n_real=1500; K2 at M=2*1536, block_f=2560, with bf16 and
   with f32 activations; K3 at B=2, T=1536, d=1280, H=20, n_real=1500; K9
   at B=2, H=10, T=1536, dh=128 and at an odd head count, H=15, dh=64):
   max error against the stated tolerance, kernel / plain / library ms
   (CUDA events) and the bound computed from the shapes against published
   H100 peaks;
3. small inputs against references: the f32 path against the oracle
   goldens (``tests/goldens/oracle_tiny.npz``: encoder states and greedy
   tokens); dh=64 encoders on the card against the same encoders' plain
   versions on the CPU: int8 at bf16 (K1, K2), float at bf16 (K3), int8
   at f32 (K2's f32 variant, no attention kernel);
4. serving through ``WhisperEngine.from_random(...).quantize()`` inside
   ``BatchedEngine(max_batch=8)``: five concurrent window requests (one
   auto-language), two more fixed-language ones, and one 45 s long-form
   request; launch counters reset just before and read just after must
   equal 32 x encoder batches; then one of the window requests again
   under ``torch.profiler`` for where the device time goes;
5. file transcription, the JAX package's default ``transcribe`` path:
   ``WhisperEngine.from_random("large-v3-turbo")`` unquantized at bf16,
   ``transcribe`` of a 12 s and a 45 s clip and of a 10 s clip on
   ``with_audio_ctx(750)`` (n_real 750 in a T=768 pad): K3 launches =
   32 x encoder batches, no other attention kernel; the same weights
   split into 10 heads of 128 (heads that do not pair) take K9 on every
   layer; one f32 int8 encoder batch at full width takes K2's f32 variant
   32 times and no K1; the CLI ``transcribe`` verb in a subprocess on a
   dh=64 tiny checkpoint and a WAV;
6. the decode-step kernels on their paths, under the reference's knobs
   (set in-process around each path and restored after): int8 cross-KV
   serving, ``BatchedEngine(quantized, max_batch=8,
   opts=DecodeOptions(q8_cross_kv=True))`` with ``NWT_Q8_KV_PALLAS=1`` and
   ``NWT_Q8_KERNEL_MIN_BYTES=1``, one concurrent wave of three requests
   (one auto-language) whose K5 and K6 launches must equal what the gates
   predict for the decoder forwards it ran (K1 = K2 = 32 x encoder
   batches, K4 = 0), then one of them under ``torch.profiler``; and K4 on
   the file path (``NWT_XATTN_KERNEL=1``, one ``transcribe`` of a 12 s clip
   on the unquantized engine: K4 once a layer in each single-token
   forward, K6 = 0). With no knob set, no earlier phase launches K4, K5
   or K6;
7. one ``kernels`` JSON line, then the result line.

Phase 2 also checks K4 and K5 (B=8 and B=1, H=20, Dh=64, Tp=1536,
t_real=1500) and K6 (the logit projection 1280 x 51,866 at M=8 with bf16
and with f32 x, fc1 1280 x 5120, fc2 5120 x 1280, M=256); phase 3 also
holds a d=128 dh=64 int8 decoder with the three knobs on against the same
model on the CPU (f32: greedy tokens equal; bf16: prefill and step
logits within a tolerance).

Imports nothing of JAX and nothing of ``nobs_whisper_tpu``.
"""

import json
import os
import subprocess
import sys
import threading
import time

# published H100 SXM peaks (dense): int8 tensor core, bf16 tensor core, HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# K1 is held to one bf16 step of its plain version, elementwise:
# |kernel - plain| <= atol + rtol * |plain| (tests/test_torch_kernels.py
# holds the plain version to the Pallas kernel the same way): both share
# every rounding rule and differ only by f32 summation order, which can
# flip one bf16 output step. The JAX tests' 2e-2 (test_encoder_attention.py
# :201-204) stays as the ceiling on the max error.
K1_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K1_TOL = 2e-2
K2_TOL = 5e-2      # tests/test_fused_mlp.py:78
# K3 and K9 share K1's attention arithmetic and are held the same way:
# one bf16 step elementwise, 2e-2 (test_encoder_attention.py) as ceiling
ATTN_STEP, ATTN_TOL = K1_STEP, K1_TOL
# K4 and K5 keep the TPU kernels' rounding points and differ from their
# plain versions in f32 summation order only, which can flip one bf16
# probability: one bf16 step elementwise, 2e-2
# (test_attention_pallas.py:59,86) as ceiling
XATTN_STEP, XATTN_TOL = K1_STEP, K1_TOL
# K6 rounds the same bf16 operands as its plain version; the order (and in
# the tensor cores the rounding) of its f32 sums differs: 1e-3 absolute +
# 1e-3 relative on outputs of order 1
K6_TOL = dict(rtol=1e-3, atol=1e-3)
# the decode kernels' knobs (models/whisper.py), set around their paths
DECODE_KNOBS = ("NWT_XATTN_KERNEL", "NWT_Q8_KV_PALLAS",
                "NWT_Q8_KERNEL_MIN_BYTES")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_card_and_build():
    import torch
    from nobs_whisper_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build = _build.build_all(force=True)
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s wall for {len(build)} sources")
    for name, rec in build.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s")
        for line in rec["ptxas"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[ptxas]   {line.strip()}")
    return smi


def k1_setup(dev, b=2, h=20, t=1536, d=1280, seed=10):
    import torch
    from nobs_whisper_torch.ops.quant import quantize_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = (rn(b, t, d) * 0.5).to(torch.bfloat16)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    mkw = lambda: quantize_int8(rn(d, d) * d ** -0.5)
    wq, wk, wv = mkw(), mkw(), mkw()
    bq, bv = 0.1 * rn(d), 0.1 * rn(d)
    return x, ln_g, ln_b, wq, bq, wk, wv, bv


def k2_setup(dev, m=2 * 1536, d=1280, f=5120, seed=2):
    import torch
    from nobs_whisper_torch.ops.quant import quantize_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = (rn(m, d) * 0.5).to(torch.bfloat16)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    fc1, fc2 = quantize_int8(rn(d, f) * d ** -0.5), \
        quantize_int8(rn(f, d) * f ** -0.5)
    return x, ln_g, ln_b, fc1, 0.1 * rn(f), fc2, 0.1 * rn(d)


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    dev = torch.device("cuda")
    out = {}

    # ---- K1 ----
    b, h, t, d, n_real = 2, 20, 1536, 1280, 1500
    args = k1_setup(dev, b, h, t, d)
    sm = float(d // h) ** -0.5
    got = ea.encoder_attention_fused_qkv(*args, n_real, sm, h)
    torch.cuda.synchronize()
    ref = ea.encoder_attention_fused_qkv_plain(*args, n_real, sm, h)
    finite = bool(torch.isfinite(got.float()).all())
    diff = (got.float() - ref.float())[:, :n_real].abs()
    err = diff.max().item()
    steps = (diff / (K1_STEP["atol"] + K1_STEP["rtol"]
                     * ref.float()[:, :n_real].abs())).max().item()
    del diff
    ms = cuda_ms(lambda: ea.encoder_attention_fused_qkv(*args, n_real, sm, h))
    plain_ms = cuda_ms(lambda: ea.encoder_attention_fused_qkv_plain(
        *args, n_real, sm, h), reps=3, warmup=1)
    qkv = [torch.randn(b, h, t, 64, device=dev, dtype=torch.bfloat16)
           for _ in range(3)]
    mask = torch.zeros(t, t, device=dev, dtype=torch.bool)
    mask[:, :n_real] = True          # (L, S): keys >= n_real masked
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *qkv, attn_mask=mask))
    m = b * t
    int8_ops = 2.0 * m * d * 3 * d
    bf16_flops = 2 * (2.0 * b * h * t * n_real * 64)
    nbytes = 2 * m * d * 2 + 3 * d * d + 3 * d * 4 + 4 * d * 4
    bound = max(int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS,
                nbytes / PEAK_BYTES) * 1e3
    ok1 = finite and steps <= 1.0 and err < K1_TOL
    log(f"[kernel] K1 encoder_attention_fused_qkv B={b} T={t} d={d} H={h} "
        f"n_real={n_real}: max_abs_err {err:.3e} (ceiling {K1_TOL}), "
        f"max |kernel - plain| / (atol + rtol |plain|) {steps:.3f} "
        f"(<= 1, {K1_STEP}) finite {finite} -> "
        f"{'PASS' if ok1 else 'FAIL'}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"(operations), SDPA on q/k/v alone {lib_ms:.4f} ms")
    out["K1"] = dict(
        name="encoder_attention_fused_qkv", route="cuda",
        source="nobs_whisper_torch/csrc/encoder_attention.cu",
        replaces="nobs_whisper_tpu/ops/encoder_attention.py:565",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations", library_ms=lib_ms, ok=ok1)
    del args, got, ref, qkv

    # ---- K2 ----
    m, d, f, bf = 2 * 1536, 1280, 5120, 2560
    args = k2_setup(dev, m, d, f)
    got = fm.encoder_mlp_int8_resident(*args, block_f=bf)
    torch.cuda.synchronize()
    ref = fm.encoder_mlp_int8_resident_plain(*args, block_f=bf)
    err = (got.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fm.encoder_mlp_int8_resident(
        *args, block_f=bf))
    plain_ms = cuda_ms(lambda: fm.encoder_mlp_int8_resident_plain(
        *args, block_f=bf), reps=3, warmup=1)
    a8 = torch.randint(-127, 128, (m, d), device=dev, dtype=torch.int8)
    h8 = torch.randint(-127, 128, (m, f), device=dev, dtype=torch.int8)
    w1, w2 = args[3]["q"], args[5]["q"]
    lib_ms = cuda_ms(lambda: (torch._int_mm(a8, w1), torch._int_mm(h8, w2)))
    ops = 2.0 * m * d * f * 2
    nbytes = 2 * m * d * 2 + 2 * d * f + (f + d) * 4 * 2 + 2 * d * 4
    bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
    ok2 = err < K2_TOL
    log(f"[kernel] K2 encoder_mlp_int8_resident M={m} d={d} ffn={f} "
        f"block_f={bf}: max_abs_err {err:.3e} (tol {K2_TOL}) -> "
        f"{'PASS' if ok2 else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (operations), "
        f"torch._int_mm fc1+fc2 alone {lib_ms:.4f} ms")
    out["K2"] = dict(
        name="encoder_mlp_int8_resident", route="cuda",
        source="nobs_whisper_torch/csrc/fused_mlp.cu",
        replaces="nobs_whisper_tpu/ops/fused_mlp.py:298",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations", library_ms=lib_ms, ok=ok2)
    del got, ref

    # ---- K2, f32 activations (the int8 encoder at f32 compute) ----
    x32 = args[0].float() + 1e-3 * torch.randn(m, d, device=dev)
    got = fm.encoder_mlp_int8_resident(x32, *args[1:], block_f=bf)
    torch.cuda.synchronize()
    ref = fm.encoder_mlp_int8_resident_plain(x32, *args[1:], block_f=bf)
    err = (got - ref).abs().max().item()
    ms = cuda_ms(lambda: fm.encoder_mlp_int8_resident(
        x32, *args[1:], block_f=bf))
    plain_ms = cuda_ms(lambda: fm.encoder_mlp_int8_resident_plain(
        x32, *args[1:], block_f=bf), reps=3, warmup=1)
    nbytes = 2 * m * d * 4 + 2 * d * f + (f + d) * 4 * 2 + 2 * d * 4
    bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
    ok2f = err < K2_TOL and got.dtype == torch.float32
    log(f"[kernel] K2-f32 encoder_mlp_int8_resident f32 M={m} d={d} "
        f"ffn={f} block_f={bf}: max_abs_err {err:.3e} (tol {K2_TOL}) -> "
        f"{'PASS' if ok2f else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (operations), "
        f"torch._int_mm fc1+fc2 alone {lib_ms:.4f} ms")
    out["K2-f32"] = dict(
        name="encoder_mlp_int8_resident (f32 activations)", route="cuda",
        source="nobs_whisper_torch/csrc/fused_mlp.cu",
        replaces="nobs_whisper_tpu/ops/fused_mlp.py:298",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations", library_ms=lib_ms, ok=ok2f)
    del args, got, ref, x32, a8, h8
    torch.cuda.empty_cache()

    # ---- K3 (flat layout) and K9 (per head) ----
    out["K3"] = attention_kernel_check(
        "K3", "encoder_attention_btd", "nobs_whisper_tpu/ops/"
        "encoder_attention.py:185", b=2, h=20, t=1536, dh=64, n_real=1500)
    out["K9"] = attention_kernel_check(
        "K9", "encoder_attention", "nobs_whisper_tpu/ops/"
        "encoder_attention.py:93", b=2, h=10, t=1536, dh=128, n_real=1500)
    odd = attention_kernel_check(
        "K9", "encoder_attention", "", b=2, h=15, t=1536, dh=64,
        n_real=1500)
    out["K9"]["ok"] &= odd["ok"]
    torch.cuda.empty_cache()
    out.update(decode_kernel_checks())
    torch.cuda.empty_cache()
    return out


def _bound(nbytes, flops):
    """(bound ms, what bounds it) against the published H100 peaks."""
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def xattn_check(key, b, h=20, t=1500, dh=64, seed=30):
    """K4 (packed bf16) or K5 (int8 cross-KV) at the decode step's shapes
    against its plain version; the yardstick is SDPA on the same bf16 q,
    K and V in the (B, H, T, Dh) layout (K5: on K/V dequantized to bf16
    before timing, twice the bytes K5 reads), keys past the real ones
    masked."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import attention_pallas as ap
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + b)
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    k = torch.randn(1, b, h, t, dh, generator=g, device=dev)
    v = torch.randn(1, b, h, t, dh, generator=g, device=dev)
    if key == "K4":
        kd, vd = ap.pack_cross_kv_bf16((k, v))
        packed = {"kT": kd["kT"][0], "v": vd["v"][0]}
        tp = packed["kT"].shape[-1]
        fn = lambda: ap.cross_attention_decode_bf16(q, packed, t)
        plain = lambda: ap.cross_attention_decode_bf16_plain(q, packed, t)
        kh = packed["kT"].transpose(-1, -2).contiguous()
        vh = packed["v"]
        mask = torch.arange(tp, device=dev)[None, :] < t
        # K and V of the real positions, q read, out written (f32)
        nbytes = 2 * b * h * t * dh * 2 + b * h * dh * (2 + 4)
        name, lib = "cross_attention_decode_bf16", "SDPA on bf16 q/k/v"
    else:
        kq, vq = ap.quantize_cross_kv((k, v))
        kq = {z: w[0] for z, w in kq.items()}
        vq = {z: w[0] for z, w in vq.items()}
        tp = kq["q"].shape[-1]
        fn = lambda: ap.cross_attention_decode_q8(q, kq, vq)
        plain = lambda: ap.cross_attention_decode_q8_plain(q, kq, vq)
        kh = (kq["q"].float() * kq["s"][:, :, None, :]).transpose(
            -1, -2).to(torch.bfloat16).contiguous()
        vh = (vq["q"].float() * vq["s"][..., None]).to(torch.bfloat16)
        mask = kq["s"][:, :, None, :] > 0
        # every position's int8 K and V and both scales (the mask is by
        # scale), q read, out written
        nbytes = b * h * tp * (2 * dh + 2 * 4) + b * h * dh * (2 + 4)
        name = "cross_attention_decode_q8"
        lib = "SDPA on K/V dequantized to bf16 (2x K5's bytes)"
    got = fn()
    torch.cuda.synchronize()
    ref = plain()
    diff = (got - ref).abs()
    err = diff.max().item()
    steps = (diff / (XATTN_STEP["atol"] + XATTN_STEP["rtol"]
                     * ref.abs())).max().item()
    finite = bool(torch.isfinite(got).all())
    ms = cuda_ms(fn, reps=50)
    plain_ms = cuda_ms(plain, reps=10, warmup=2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kh, vh, attn_mask=mask, scale=float(dh) ** -0.5), reps=50)
    bound, by = _bound(nbytes, 4.0 * b * h * t * dh)
    ok = finite and steps <= 1.0 and err < XATTN_TOL
    log(f"[kernel] {key} {name} B={b} H={h} Dh={dh} Tp={tp} t_real={t}: "
        f"max_abs_err {err:.3e} (ceiling {XATTN_TOL}), max |kernel - plain|"
        f" / (atol + rtol |plain|) {steps:.3f} (<= 1, {XATTN_STEP}) finite "
        f"{finite} -> {'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, {nbytes / 1e6:.2f} "
        f"MB), {lib} {lib_ms:.4f} ms")
    return dict(name=name, route="cuda",
                source="nobs_whisper_torch/csrc/cross_attention_decode.cu",
                replaces=("nobs_whisper_tpu/ops/attention_pallas.py:189"
                          if key == "K4" else
                          "nobs_whisper_tpu/ops/attention_pallas.py:111"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, ok=ok)


def q8_check(m, k, n, x_dtype, what, seed=40):
    """K6 on one decoder weight shape against its plain version; the
    yardstick is torch.matmul of bf16 x with the weight dequantized to
    bf16 before timing."""
    import torch
    from nobs_whisper_torch.ops import quant as qt
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
    w = qt.quantize_int8(torch.randn(k, n, generator=g, device=dev)
                         * k ** -0.5)
    got = qt.q8_matmul(x, w)
    torch.cuda.synchronize()
    ref = qt.q8_matmul_plain(x, w)
    err = (got - ref).abs().max().item()
    close = bool(torch.allclose(got, ref, **K6_TOL))
    ms = cuda_ms(lambda: qt.q8_matmul(x, w), reps=50)
    plain_ms = cuda_ms(lambda: qt.q8_matmul_plain(x, w), reps=10, warmup=2)
    xb = x.to(torch.bfloat16)
    wb = (w["q"].to(torch.bfloat16) * w["s"].to(torch.bfloat16))
    lib_ms = cuda_ms(lambda: torch.matmul(xb, wb), reps=50)
    nbytes = k * n + n * 4 + m * k * x.element_size() + m * n * 4
    bound, by = _bound(nbytes, 2.0 * m * k * n)
    ok = close and bool(torch.isfinite(got).all())
    log(f"[kernel] K6 q8_matmul {what} M={m} K={k} N={n} x {x_dtype}: "
        f"max_abs_err {err:.3e} ({K6_TOL}) -> {'PASS' if ok else 'FAIL'}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms"
        f" ({by}, {nbytes / 1e6:.2f} MB), torch.matmul on bf16-dequantized "
        f"weight {lib_ms:.4f} ms")
    return dict(name="q8_matmul", route="cuda",
                source="nobs_whisper_torch/csrc/q8_matmul.cu",
                replaces="nobs_whisper_tpu/ops/quant.py:73", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, ok=ok)


def decode_kernel_checks():
    """K4 and K5 at B=8 and B=1 (the line keeps B=8), K6 on the decoder's
    shapes (the line keeps the logit projection with f32 x, which the
    serving path runs; every check must pass)."""
    import torch
    out = {}
    for key in ("K4", "K5"):
        e8 = xattn_check(key, b=8)
        e1 = xattn_check(key, b=1)
        e8["ok"] &= e1["ok"]
        out[key] = e8
    logits = q8_check(8, 1280, 51866, torch.float32, "logits")
    ok = logits["ok"]
    for args in ((8, 1280, 51866, torch.bfloat16, "logits"),
                 (8, 1280, 5120, torch.bfloat16, "fc1"),
                 (8, 5120, 1280, torch.bfloat16, "fc2"),
                 (256, 1280, 51866, torch.bfloat16, "logits, M=256")):
        e = q8_check(*args)
        ok &= e["ok"]
        logits["max_abs_err"] = max(logits["max_abs_err"], e["max_abs_err"])
    logits["ok"] = ok
    out["K6"] = logits
    return out


def attention_kernel_check(key, name, replaces, b, h, t, dh, n_real):
    """K3 (flat (B, T, H dh)) or K9 ((B, H, T, dh)) against its plain
    version on random bf16 q/k/v; the library yardstick is SDPA on the
    same q/k/v in the (B, H, T, dh) view, keys >= n_real masked."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import encoder_attention as ea
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(t + h + dh)
    shape = (b, t, h * dh) if key == "K3" else (b, h, t, dh)
    q, k, v = ((torch.randn(*shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(3))
    sm = float(dh) ** -0.5
    if key == "K3":
        fn = lambda: ea.encoder_attention_btd(q, k, v, n_real, sm, h)
        plain = lambda: ea.encoder_attention_btd_plain(q, k, v, n_real, sm, h)
        heads = lambda z: z.view(b, t, h, dh).transpose(1, 2)
        real = (slice(None), slice(0, n_real))
    else:
        fn = lambda: ea.encoder_attention(q, k, v, n_real, sm)
        plain = lambda: ea.encoder_attention_plain(q, k, v, n_real, sm)
        heads = lambda z: z
        real = (Ellipsis, slice(0, n_real), slice(None))
    got = fn()
    torch.cuda.synchronize()
    ref = plain()
    finite = bool(torch.isfinite(got.float()).all())
    diff = (got.float() - ref.float())[real].abs()
    err = diff.max().item()
    steps = (diff / (ATTN_STEP["atol"] + ATTN_STEP["rtol"]
                     * ref.float()[real].abs())).max().item()
    del diff, ref
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    mask = torch.zeros(1, t, device=dev, dtype=torch.bool)
    mask[:, :n_real] = True          # (1, S): keys >= n_real masked
    qh, kh, vh = heads(q), heads(k), heads(v)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=sm))
    flops = 4.0 * b * h * t * n_real * dh      # QK^T and PV over real keys
    nbytes = 4 * b * t * h * dh * 2            # q, k, v read, out written
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES \
        else "bytes"
    ok = finite and steps <= 1.0 and err < ATTN_TOL
    log(f"[kernel] {key} {name} B={b} T={t} H={h} dh={dh} n_real={n_real}: "
        f"max_abs_err {err:.3e} (ceiling {ATTN_TOL}), max |kernel - plain| "
        f"/ (atol + rtol |plain|) {steps:.3f} (<= 1, {ATTN_STEP}) finite "
        f"{finite} -> {'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), SDPA {lib_ms:.4f} "
        f"ms")
    return dict(name=name, route="cuda",
                source="nobs_whisper_torch/csrc/encoder_attention.cu",
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, ok=ok)


GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "goldens", "oracle_tiny.npz")
GOLDEN_XA_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_goldens.py's bounds
ENC_TOL = 5e-2    # tests/test_torch_kernels_gpu.py: int8 encoder, 2 layers


def _load_goldens(dev):
    """The repo's oracle goldens (params, mel, xa, prompt, greedy tokens)
    as a torch parameter tree on ``dev``; no JAX needed."""
    import re
    import numpy as np
    from nobs_whisper_torch.core.config import WhisperConfig
    from nobs_whisper_torch.models import whisper as mw
    z = np.load(GOLDENS)
    params = {}
    for key in z.files:
        if not key.startswith("params["):
            continue
        path = re.findall(r"\['([^']+)'\]", key)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = z[key]
    cfg = WhisperConfig(name="goldens-tiny", force_multilingual=True,
                        **json.loads(bytes(z["cfg_json"]).decode()))
    return z, mw.params_from_jax(params, device=dev), cfg


def phase_reference():
    """Small inputs against references, on the card:

    * the f32 float path (no kernels) against the oracle goldens: encoder
      states within the golden tests' bounds, greedy tokens equal;
    * encoders at a dh=64 width on the card against the same encoders'
      plain versions on the CPU: int8 at bf16 (K1, K2), float at bf16
      (K3), int8 at f32 (K2's f32 variant)."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    dev = torch.device("cuda")

    z, params, cfg = _load_goldens(dev)
    xa = mw.encode(params, torch.from_numpy(z["mel"]).to(dev), cfg)
    xa_ok = np.allclose(xa.cpu().numpy(), z["xa"], **GOLDEN_XA_TOL)
    xa_err = float(np.abs(xa.cpu().numpy() - z["xa"]).max())
    opts = DecodeOptions(suppress_blank=True)
    res = decode_window(params, torch.from_numpy(z["xa"]).to(dev),
                        [z["prompt"].tolist()], cfg,
                        build_rule_tables(cfg, opts), opts)[0]
    want = z["greedy_tokens"].tolist()
    tok_ok = res.tokens == want
    log(f"[reference] f32 path vs oracle goldens: encoder max_abs_err "
        f"{xa_err:.3e} ({GOLDEN_XA_TOL}) -> {'PASS' if xa_ok else 'FAIL'}; "
        f"greedy tokens {len(res.tokens)} equal {tok_ok} -> "
        f"{'PASS' if tok_ok else 'FAIL'}")

    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    qp = quantize_encoder_params(mw.init_params(3, cfg, dtype=torch.bfloat16))
    mel = torch.from_numpy(
        np.random.RandomState(4).randn(2, cfg.n_mels, 64).astype(np.float32))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    k1, k2 = ea.launch_count, fm.launch_count
    got = mw.encode(to_dev(qp), mel.to(dev), cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    through = (ea.launch_count - k1, fm.launch_count - k2) == \
        (cfg.n_audio_layer, cfg.n_audio_layer)
    ref = mw.encode(qp, mel, cfg, compute_dtype=torch.bfloat16)
    err = (got.float().cpu() - ref.float()).abs().max().item()
    enc_ok = through and bool(torch.isfinite(got.float()).all()) \
        and err < ENC_TOL
    log(f"[reference] int8 encoder d=128 dh=64 card (K1, K2) vs CPU plain: "
        f"max_abs_err {err:.3e} (tol {ENC_TOL}), kernels launched per layer "
        f"{through} -> {'PASS' if enc_ok else 'FAIL'}")

    # the float encoder at bf16 (K3 once per layer), and the int8 encoder
    # at f32 compute (the reference's TPU gate: K2's f32 variant, no
    # attention kernel), each against its CPU run
    fp = mw.init_params(3, cfg, dtype=torch.bfloat16)
    k3 = ea.k3_launch_count
    got = mw.encode(to_dev(fp), mel.to(dev), cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    through = ea.k3_launch_count - k3 == cfg.n_audio_layer
    ref = mw.encode(fp, mel, cfg, compute_dtype=torch.bfloat16)
    err = (got.float().cpu() - ref.float()).abs().max().item()
    k3_ok = through and bool(torch.isfinite(got.float()).all()) \
        and err < ENC_TOL
    log(f"[reference] float encoder d=128 dh=64 bf16 card (K3) vs CPU plain: "
        f"max_abs_err {err:.3e} (tol {ENC_TOL}), K3 launched per layer "
        f"{through} -> {'PASS' if k3_ok else 'FAIL'}")

    qp32 = quantize_encoder_params(mw.init_params(3, cfg))
    k1, k2f = ea.launch_count, fm.launch_count_f32
    got = mw.encode(to_dev(qp32), mel.to(dev), cfg)
    torch.cuda.synchronize()
    through = (ea.launch_count - k1, fm.launch_count_f32 - k2f) == \
        (0, cfg.n_audio_layer)
    ref = mw.encode(qp32, mel, cfg)
    err = (got.cpu() - ref).abs().max().item()
    f32_ok = through and got.dtype == torch.float32 \
        and bool(torch.isfinite(got).all()) and err < ENC_TOL
    log(f"[reference] int8 encoder d=128 dh=64 f32 card (K2 f32, no K1) vs "
        f"CPU plain: max_abs_err {err:.3e} (tol {ENC_TOL}), launches per "
        f"layer {through} -> {'PASS' if f32_ok else 'FAIL'}")
    with knobs(DECODE_KNOBS):
        dec_ok = reference_decoder(dev)
    return xa_ok and tok_ok and enc_ok and k3_ok and f32_ok and dec_ok


DEC_LOGIT_TOL = 5e-2   # bf16 decoder, 2 layers: see reference_decoder


class knobs:
    """Set environment knobs to "1" in-process; restore them on exit."""

    def __init__(self, names):
        self.names = names

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.names}
        for k in self.names:
            os.environ[k] = "1"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


DEC_SEED = 6


def reference_decoder(dev):
    """A d=128 dh=64 int8 decoder (and its tiny logit projection, N=1000)
    with the three decode knobs on, on the card against the same model's
    plain run on the CPU:

    * f32 compute, int8 cross-KV (K5, K6) and the packed layout (K4, K6):
      greedy tokens equal, and the launches what the gates predict;
    * int8 cross-KV at f32 and at bf16 compute: the prefill logits (K6
      alone: more than one token) and the next single-token forward's (K5
      and K6) within 5e-2 of the CPU's. The two runs share every rounding
      rule, but K5 and K6 round their inputs to bf16 as the TPU kernels
      do, also at f32 compute, so an f32 summation-order difference
      upstream can become a bf16 step (2^-8 relative) of one input, which
      moves a logit of order 1 by about 1e-2.

    Greedy tokens follow the logits only where no two choices are that
    close: on weight seed 5 one of the three int8 cross-KV windows
    diverged between card and CPU; seed 6 is the model here."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=160, n_text_ctx=64)
    params = quantize_decoder_params(mw.init_params(DEC_SEED, cfg))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    xa = torch.from_numpy(np.random.RandomState(6).randn(
        3, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    prompts = [[cfg.sot, cfg.lang_base + i, cfg.transcribe]
               for i in range(3)]
    ok = True
    for opts in (DecodeOptions(q8_cross_kv=True),
                 DecodeOptions(xattn_bf16=True)):
        tables = build_rule_tables(cfg, opts)
        reset_counts()
        got = decode_window(to_dev(params), xa.to(dev), prompts, cfg,
                            tables, opts)
        torch.cuda.synchronize()
        c = read_counts()
        want = predicted_decode_launches(c["forwards"], cfg.n_text_layer)
        ref = decode_window(params, xa, prompts, cfg, tables, opts)
        same = [r.tokens for r in got] == [r.tokens for r in ref]
        first = [next((i for i, (a, b) in enumerate(zip(g.tokens, r.tokens))
                       if a != b), None) for g, r in zip(got, ref)]
        counts_ok = all(c[k] == want[k] for k in want) and c["K6"] > 0
        layout = "q8" if opts.q8_cross_kv else "packed"
        log(f"[reference] int8 decoder d=128 dh=64 f32 {layout} cross-KV, "
            f"knobs on, card vs CPU plain: greedy tokens "
            f"{[len(r.tokens) for r in got]} equal {same} (first "
            f"difference by window {first}); launches "
            f"K4 {c['K4']} K5 {c['K5']} K6 {c['K6']} (want {want}) -> "
            f"{'PASS' if same and counts_ok else 'FAIL'}")
        ok &= same and counts_ok

    # prefill and one step on int8 cross-KV, both packages' compute dtypes
    for dt in (torch.float32, torch.bfloat16):
        p = quantize_decoder_params(mw.init_params(DEC_SEED, cfg, dtype=dt))
        logits = []
        for pp, x in ((to_dev(p), xa.to(dev, dt)), (p, xa.to(dt))):
            cross = mw.precompute_cross_kv_q8(pp, x, cfg)
            cache = mw.init_kv_cache(cfg, 3, dtype=dt, t_ctx=16,
                                     device=x.device)
            toks = torch.tensor([[cfg.eot] * 5 + q for q in prompts],
                                device=x.device)
            pad = torch.full((3,), 5, device=x.device)
            pre, cache = mw.decoder_forward(pp, toks, 0, pad, cache, cross,
                                            cfg, dt)
            # the same next token on both sides: the CPU's would do as well
            nxt = torch.full((3, 1), cfg.sot, device=x.device)
            step, _ = mw.decoder_forward(pp, nxt, 8, pad, cache, cross, cfg,
                                         dt)
            logits.append((pre.float().cpu(), step.float().cpu()))
        (pc, sc_), (pr, sr) = logits
        e_pre = (pc - pr).abs().max().item()
        e_step = (sc_ - sr).abs().max().item()
        lg_ok = (e_pre < DEC_LOGIT_TOL and e_step < DEC_LOGIT_TOL
                 and bool(torch.isfinite(pc).all()
                          and torch.isfinite(sc_).all()))
        log(f"[reference] int8 decoder d=128 dh=64 {str(dt)[6:]} int8 "
            f"cross-KV, knobs on, card vs CPU plain: prefill logits "
            f"max_abs_err {e_pre:.3e}, step logits {e_step:.3e} (tol "
            f"{DEC_LOGIT_TOL}, logits up to {pr.abs().max().item():.2f}) -> "
            f"{'PASS' if lg_ok else 'FAIL'}")
        ok &= lg_ok
    return ok


def predicted_decode_launches(forwards, n_layer):
    """K4, K5 and K6 launches the gates predict for the decoder forwards
    run (``models/whisper.py::decoder_forward_calls``, by cross-KV layout,
    batch and tokens), with every knob on and K6's threshold at 1 byte: K4
    or K5 once a layer in a single-token forward on the packed or int8
    cross-KV; K6 on the 8 int8 weights of each layer and the logit
    projection in a forward of at most 256 rows. (The cross-KV projection
    has B x 1500 rows at full size, B x 160 in the reference phase: no K6
    there.)"""
    n = lambda pred: sum(c for key, c in forwards.items() if pred(*key))
    return {"K4": n_layer * n(lambda lay, b, s: lay == "packed" and s == 1),
            "K5": n_layer * n(lambda lay, b, s: lay == "q8" and s == 1),
            "K6": (8 * n_layer + 1) * n(lambda lay, b, s: b * s <= 256)}


def _request_audio():
    """Wave 1: five concurrent requests, one of them auto-language (the
    batch then runs encode + language detection, then decode); wave 2: two
    fixed-language requests (the one-program frames -> decode path)."""
    from nobs_whisper_torch.utils.testing import sine_audio, speech_like_audio
    return [
        ("en-5s", speech_like_audio(5.0, seed=1), "en"),
        ("en-12s", speech_like_audio(12.0, seed=2), "en"),
        ("en-18s", sine_audio(18.0, freq=330.0) +
         speech_like_audio(18.0, seed=3), "en"),
        ("en-25s", speech_like_audio(25.0, seed=4), "en"),
        ("auto-8s", speech_like_audio(8.0, seed=5), None),
    ], [
        ("en-10s", speech_like_audio(10.0, seed=6), "en"),
        ("en-20s", speech_like_audio(20.0, seed=7), "en"),
    ]


def _run_wave(be, wave, card):
    import math
    results, errors = {}, []

    def one(name, audio, lang):
        t0 = time.perf_counter()
        try:
            r = be.transcribe(audio, language=lang)
            results[name] = (r, time.perf_counter() - t0, len(audio) / 16000)
        except Exception as e:  # reported below, fails the phase
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=one, args=w) for w in wave]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ok = not errors and len(results) == len(wave)
    for name, err in errors:
        log(f"[serve] {name}: FAILED {err}")
    for name, (r, dt, dur) in sorted(results.items()):
        toks = sum(len(s.tokens) for s in r.segments)
        finite = all(math.isfinite(s.avg_logprob)
                     and math.isfinite(s.no_speech_prob) for s in r.segments)
        ok &= finite and isinstance(r.text, str)
        log(f"[serve] {card}: {name} ({dur:.1f} s audio) latency "
            f"{dt * 1e3:.1f} ms, tokens {toks}, segments "
            f"{len(r.segments)}, language {r.language}, finite {finite}")
    return ok


def phase_serving(card, eng):
    """``eng``: the large-v3-turbo engine's ``quantize()`` (int8 encoder
    and decoder)."""
    import torch
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = eng.cfg
    be = BatchedEngine(eng, max_batch=8)
    wave1, wave2 = _request_audio()
    try:
        reset_counts()
        t0 = time.perf_counter()
        ok = _run_wave(be, wave1, card)
        ok &= _run_wave(be, wave2, card)
        ok &= _run_wave(be, [("longform-45s", speech_like_audio(
            45.0, seed=8), "en")], card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        launches = {"K1": c["K1"], "K2": c["K2"]}
        batches = c["batches"]
        want = cfg.n_audio_layer * batches
        counts_ok = (batches > 0 and launches["K1"] == want
                     and launches["K2"] == want
                     and c["K3"] == c["K9"] == c["K2-f32"] == 0
                     and c["K4"] == c["K5"] == c["K6"] == 0)
        log(f"[serve] {card}: wall {wall:.2f} s; batch sizes "
            f"{be.batcher.batch_sizes}; encoder batches {batches}; "
            f"launches K1 {launches['K1']} K2 {launches['K2']} "
            f"(want {cfg.n_audio_layer} x {batches} = {want}) -> "
            f"{'PASS' if counts_ok else 'FAIL'}")
        ok &= counts_ok
        # one request of wave 1 again, the same one the int8 cross-KV
        # phase profiles, so that the two profiles compare request for
        # request
        profile_wave(be, [wave1[1]], card)
    finally:
        be.close()
    return ok, launches


def profile_wave(be, wave, card):
    """One more concurrent wave under torch.profiler: device time by
    kernel, the device's idle share of the wave's wall time, and the
    device time of dtype copies (``copy`` kernels: on the int8 decoder's
    default path, the per-step dequantization of every weight). Outside
    the counted run; a profiler failure is reported, not fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            _run_wave(be, wave, card)
            torch.cuda.synchronize()
            # the wave's own wall, not the trace's processing at exit
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        rows = sorted(ka, key=lambda e: -getattr(e, attr))
        busy_s = sum(getattr(e, attr) for e in ka) / 1e6
    except Exception as e:
        log(f"[profile] not measured: {e!r}")
        return
    copy_ms = sum(getattr(e, attr) for e in ka if "copy" in e.key) / 1e3
    top_copies = sum("copy" in e.key for e in rows[:15])
    log(f"[profile] {card}: profiled wave wall {wall:.3f} s, device busy "
        f"{busy_s:.3f} s (self device time summed), idle share "
        f"{max(0.0, 1 - busy_s / wall):.3f}; dtype-copy kernels "
        f"{copy_ms:.2f} ms device time, {top_copies} of the 15 largest rows")
    for e in rows[:15]:
        t = getattr(e, attr)
        if t <= 0:
            break
        log(f"[profile]   {t / 1e3:10.2f} ms  {e.count:7d}x  {e.key[:90]}")


def reset_counts():
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import quant as qt
    ea.launch_count = ea.k3_launch_count = ea.k9_launch_count = 0
    fm.launch_count = fm.launch_count_f32 = 0
    ap.k4_launch_count = ap.k5_launch_count = qt.k6_launch_count = 0
    mw.encode_count = 0
    mw.decoder_forward_calls.clear()


def read_counts():
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import quant as qt
    return {"K1": ea.launch_count, "K3": ea.k3_launch_count,
            "K9": ea.k9_launch_count, "K2": fm.launch_count,
            "K2-f32": fm.launch_count_f32, "K4": ap.k4_launch_count,
            "K5": ap.k5_launch_count, "K6": qt.k6_launch_count,
            "batches": mw.encode_count,
            "forwards": dict(mw.decoder_forward_calls)}


def _launch_summary(c):
    return {k: v for k, v in c.items() if k != "forwards"}


def _transcribe_one(eng, name, audio, card, opts):
    import math
    t0 = time.perf_counter()
    r = eng.transcribe(audio, language="en", opts=opts)
    dt = time.perf_counter() - t0
    toks = sum(len(s.tokens) for s in r.segments)
    ok = isinstance(r.text, str) and all(
        math.isfinite(s.avg_logprob) and math.isfinite(s.no_speech_prob)
        for s in r.segments)
    log(f"[transcribe] {card}: {name} ({len(audio) / 16000:.1f} s audio) "
        f"latency {dt * 1e3:.1f} ms, tokens {toks}, segments "
        f"{len(r.segments)}, finite {ok}")
    return ok


def phase_transcribe(card, eng):
    """The JAX package's default file path (``cli transcribe``): ``eng``,
    the unquantized large-v3-turbo engine at bf16 compute. Counts are set
    to 0 just before each path and read just after it."""
    import dataclasses
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import speech_like_audio

    # random weights never emit eot: one greedy rung per window (224
    # steps) instead of the 6-rung temperature ladder
    opts = DecodeOptions(temperature_increment=0.0)
    cfg = eng.cfg

    # K3: heads pair (dh = 64)
    reset_counts()
    ok = _transcribe_one(eng, "en-12s", speech_like_audio(12.0, seed=21),
                         card, opts)
    ok &= _transcribe_one(eng, "longform-45s",
                          speech_like_audio(45.0, seed=22), card, opts)
    ok &= _transcribe_one(eng.with_audio_ctx(750), "audio_ctx750-10s",
                          speech_like_audio(10.0, seed=23), card, opts)
    torch.cuda.synchronize()
    c = read_counts()
    want = cfg.n_audio_layer * c["batches"]
    k3_ok = c["batches"] > 0 and c["K3"] == want and \
        c["K1"] == c["K9"] == c["K2"] == c["K4"] == c["K5"] == c["K6"] == 0
    log(f"[transcribe] {card}: encoder batches {c['batches']}; launches "
        f"{_launch_summary(c)} (want K3 = {cfg.n_audio_layer} x "
        f"{c['batches']} = {want}, others 0) -> "
        f"{'PASS' if k3_ok else 'FAIL'}")
    launches = {"K3": c["K3"]}

    # K9: the same weights split into heads of 128 (10 at turbo width),
    # which do not pair into 128 lanes (the decoder's heads too: the
    # packages derive one head width from the config)
    h128 = cfg.n_audio_state // 128
    eng10 = dataclasses.replace(eng, cfg=dataclasses.replace(
        cfg, n_audio_head=h128, n_text_head=h128))
    reset_counts()
    ok &= _transcribe_one(eng10, "heads10-12s",
                          speech_like_audio(12.0, seed=24), card, opts)
    torch.cuda.synchronize()
    c = read_counts()
    want = cfg.n_audio_layer * c["batches"]
    k9_ok = c["batches"] > 0 and c["K9"] == want and \
        c["K1"] == c["K3"] == c["K4"] == c["K5"] == c["K6"] == 0
    log(f"[transcribe] {card}: 10 heads of 128: launches "
        f"{_launch_summary(c)} (want K9 = {cfg.n_audio_layer} x "
        f"{c['batches']} = {want}) -> {'PASS' if k9_ok else 'FAIL'}")
    launches["K9"] = c["K9"]

    # the int8 encoder at f32 compute: one batch at full width
    enc32 = {"encoder": {k: (v.float() if torch.is_tensor(v) else
                             {kk: vv.float() for kk, vv in v.items()})
                         for k, v in eng.params["encoder"].items()}}
    enc32 = quantize_encoder_params(enc32)
    del eng10
    torch.cuda.empty_cache()
    mel = torch.from_numpy(np.random.RandomState(25).randn(
        1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)).cuda()
    reset_counts()
    xa = mw.encode(enc32, mel, cfg, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    c = read_counts()
    f32_ok = (c["K2-f32"] == c["K2"] == cfg.n_audio_layer and c["K1"] == 0
              and xa.dtype == torch.float32
              and tuple(xa.shape) == (1, cfg.n_audio_ctx, cfg.n_audio_state)
              and bool(torch.isfinite(xa).all()))
    log(f"[transcribe] {card}: int8 encoder at f32, one batch: launches "
        f"{_launch_summary(c)} (want K2-f32 = K2 = {cfg.n_audio_layer}, "
        f"K1 = 0), states "
        f"{tuple(xa.shape)} finite -> {'PASS' if f32_ok else 'FAIL'}")
    launches["K2-f32"] = c["K2-f32"]
    del enc32, xa
    torch.cuda.empty_cache()
    return ok and k3_ok and k9_ok and f32_ok and phase_cli(card), launches


def phase_decode_kernels(card, qeng, eng):
    """The decode-step kernels on their paths, the knobs set in-process
    around each and restored after; counts set to 0 just before each path
    and read just after it.

    * int8 cross-KV serving (``qeng``, the quantized engine): K5 once a
      layer in each single-token forward on the int8 cross-KV, K6 on every
      int8 decoder weight in each forward of at most 256 rows, K1 = K2 =
      32 x encoder batches, K4 = 0; then one request again under the
      profiler;
    * K4 on the file path (``eng``, unquantized bf16): once a layer in
      each single-token forward, K6 = 0."""
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    cfg = qeng.cfg
    n_layer = cfg.n_text_layer
    wave1, _ = _request_audio()
    wave = [wave1[1], wave1[3], wave1[4]]          # 12 s, 25 s, auto 8 s
    launches = {}
    with knobs(("NWT_Q8_KV_PALLAS", "NWT_Q8_KERNEL_MIN_BYTES")):
        be = BatchedEngine(qeng, max_batch=8,
                           opts=DecodeOptions(q8_cross_kv=True))
        try:
            reset_counts()
            t0 = time.perf_counter()
            ok = _run_wave(be, wave, card)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = read_counts()
            want = predicted_decode_launches(c["forwards"], n_layer)
            want.update(K1=cfg.n_audio_layer * c["batches"],
                        K2=cfg.n_audio_layer * c["batches"])
            q8_forwards = sum(n for (lay, _, _), n in c["forwards"].items()
                              if lay == "q8")
            counts_ok = (c["batches"] > 0 and q8_forwards > 0
                         and want["K4"] == 0
                         and all(c[k] == want[k] for k in want)
                         and c["K3"] == c["K9"] == c["K2-f32"] == 0)
            log(f"[decode] {card}: int8 cross-KV wave wall {wall:.2f} s; "
                f"batch sizes {be.batcher.batch_sizes}; decoder forwards "
                f"{c['forwards']}; launches {_launch_summary(c)} (want "
                f"{want}) -> {'PASS' if counts_ok else 'FAIL'}")
            ok &= counts_ok
            launches.update(K5=c["K5"], K6=c["K6"])
            profile_wave(be, wave[:1], card)        # en-12s, as in serving
        finally:
            be.close()

    # K4 on the file path: the unquantized bf16 engine, packed cross-KV
    opts = DecodeOptions(temperature_increment=0.0)
    with knobs(("NWT_XATTN_KERNEL",)):
        reset_counts()
        ok &= _transcribe_one(eng, "en-12s K4", speech_like_audio(
            12.0, seed=27), card, opts)
        torch.cuda.synchronize()
        c = read_counts()
    want = predicted_decode_launches(c["forwards"], n_layer)
    k4_ok = (c["K4"] == want["K4"] > 0 and c["K5"] == c["K6"] == 0
             and c["K3"] == cfg.n_audio_layer * c["batches"])
    log(f"[decode] {card}: file path with NWT_XATTN_KERNEL=1: decoder "
        f"forwards {c['forwards']}; launches {_launch_summary(c)} (want K4 "
        f"{want['K4']}, K5 = K6 = 0) -> {'PASS' if k4_ok else 'FAIL'}")
    launches["K4"] = c["K4"]
    return ok and k4_ok, launches


def phase_cli(card):
    """``python -m nobs_whisper_torch.cli transcribe`` in a subprocess on
    the card (default device and dtype: cuda, bf16), on a dh=64 tiny GGML
    checkpoint and a WAV written by the port's own helpers."""
    import tempfile
    from nobs_whisper_torch.audio.io import write_wav
    from nobs_whisper_torch.utils.testing import (speech_like_audio,
                                                  tiny_test_config,
                                                  write_tiny_checkpoint)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "ggml-tiny-dh64.bin")
        wav = os.path.join(tmp, "clip.wav")
        write_tiny_checkpoint(model, cfg=tiny_test_config(d=128, heads=2),
                              seed=3)
        write_wav(wav, speech_like_audio(2.0, seed=26))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nobs_whisper_torch.cli", "transcribe",
             wav, "--model", model, "--language", "en"],
            capture_output=True, text=True, cwd=root, timeout=300)
    lines = r.stdout.strip().splitlines()
    ok = r.returncode == 0 and bool(lines)
    log(f"[cli] {card}: transcribe verb exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s, last line {lines[-1][:60]!r}"
        if lines else f"[cli] {card}: exit {r.returncode}, no output; "
        f"stderr {r.stderr[-2000:]}")
    log(f"[cli] -> {'PASS' if ok else 'FAIL'}")
    return ok


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from nobs_whisper_torch.core.device import disable_tf32
    disable_tf32()
    t_start = time.perf_counter()
    smi = phase_card_and_build()
    card = smi
    ok, launches = True, {}
    kern = phase_kernels()
    ok &= phase_reference()
    from nobs_whisper_torch.api import WhisperEngine
    t0 = time.perf_counter()
    eng = WhisperEngine.from_random("large-v3-turbo", seed=0, device="cuda")
    torch.cuda.synchronize()
    cfg = eng.cfg
    log(f"[engine] large-v3-turbo d={cfg.n_audio_state} enc_layers="
        f"{cfg.n_audio_layer} dec_layers={cfg.n_text_layer} heads "
        f"{cfg.n_audio_head}, random weights from seed 0, bf16: built "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qeng = eng.quantize()
    torch.cuda.synchronize()
    log(f"[serve] engine large-v3-turbo int8 encoder and decoder, bf16 "
        f"compute, seed 0: quantized in {time.perf_counter() - t0:.1f} s")
    serve_ok, counts = phase_serving(card, qeng)
    ok &= serve_ok
    launches.update(counts)
    tr_ok, counts = phase_transcribe(card, eng)
    ok &= tr_ok
    launches.update(counts)
    dec_ok, counts = phase_decode_kernels(card, qeng, eng)
    ok &= dec_ok
    launches.update(counts)
    entries = []
    for key, e in kern.items():
        e = dict(e)
        ok &= e.pop("ok")
        e["launches"] = launches.get(key, 0)
        ok &= e["launches"] > 0
        entries.append(e)
    log(f"[done] {card}: total {time.perf_counter() - t_start:.1f} s, "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        return 1
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
