#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nobs_whisper_torch``) on one
NVIDIA card, at the full width and depth of large-v3-turbo with int8
weights made from a seed.

Run from the repo root: ``python3 chip_smoke.py`` (one card, no
arguments). Phases; any failure exits non-zero before the result line:

1. card and build: ``nvidia-smi`` name and power limit, torch/CUDA
   versions, one ``nvcc`` per kernel source started together, with the
   ``-Xptxas -v`` summary;
2. kernels against their plain PyTorch versions at turbo width (K1 at
   B=2, T=1536, n_real=1500; K2 at M=2*1536, block_f=2560): max error
   against the stated tolerance, kernel / plain / library ms (CUDA events)
   and the bound computed from the shapes against published H100 peaks;
3. small inputs against references: the f32 path against the oracle
   goldens (``tests/goldens/oracle_tiny.npz``: encoder states and greedy
   tokens), and a dh=64 int8 encoder through K1/K2 against the same
   encoder's plain versions on the CPU;
4. serving through ``WhisperEngine.from_random(...).quantize()`` inside
   ``BatchedEngine(max_batch=8)``: five concurrent window requests (one
   auto-language), two more fixed-language ones, and one 45 s long-form
   request; launch counters reset
   just before and read just after must equal 32 x encoder batches;
   then one more concurrent wave under ``torch.profiler`` for where the
   device time goes (the largest kernels by device time);
5. one ``kernels`` JSON line, then the result line.

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
    del args, got, ref
    torch.cuda.empty_cache()
    return out


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
    * the int8 bf16 encoder at a dh=64 width, which goes through K1 and K2
      on the card, against the same encoder's plain versions on the CPU."""
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

    # the kernels take bf16 activations: an int8 encoder at f32 compute
    # on the card must raise, not compute another function
    k1, k2 = ea.launch_count, fm.launch_count
    try:
        mw.encode(to_dev(qp), mel.to(dev), cfg, compute_dtype=torch.float32)
        raised = False
    except NotImplementedError:
        raised = True
    raised &= (ea.launch_count, fm.launch_count) == (k1, k2)
    log(f"[reference] int8 encoder at f32 compute on the card raises "
        f"NotImplementedError: {raised} -> {'PASS' if raised else 'FAIL'}")
    return xa_ok and tok_ok and enc_ok and raised


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


def phase_serving(card):
    import torch
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio

    t0 = time.perf_counter()
    eng = WhisperEngine.from_random("large-v3-turbo", seed=0,
                                    device="cuda").quantize()
    torch.cuda.synchronize()
    cfg = eng.cfg
    log(f"[serve] engine large-v3-turbo d={cfg.n_audio_state} "
        f"enc_layers={cfg.n_audio_layer} dec_layers={cfg.n_text_layer} "
        f"int8, bf16 compute, seed 0: built in "
        f"{time.perf_counter() - t0:.1f} s")
    be = BatchedEngine(eng, max_batch=8)
    wave1, wave2 = _request_audio()
    try:
        ea.launch_count = fm.launch_count = 0
        mw.encode_count = 0
        t0 = time.perf_counter()
        ok = _run_wave(be, wave1, card)
        ok &= _run_wave(be, wave2, card)
        ok &= _run_wave(be, [("longform-45s", speech_like_audio(
            45.0, seed=8), "en")], card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": ea.launch_count, "K2": fm.launch_count}
        batches = mw.encode_count
        want = cfg.n_audio_layer * batches
        counts_ok = (batches > 0 and launches["K1"] == want
                     and launches["K2"] == want)
        log(f"[serve] {card}: wall {wall:.2f} s; batch sizes "
            f"{be.batcher.batch_sizes}; encoder batches {batches}; "
            f"launches K1 {launches['K1']} K2 {launches['K2']} "
            f"(want {cfg.n_audio_layer} x {batches} = {want}) -> "
            f"{'PASS' if counts_ok else 'FAIL'}")
        ok &= counts_ok
        profile_wave(be, wave1, card)
    finally:
        be.close()
    return ok, launches


def profile_wave(be, wave, card):
    """One more concurrent wave under torch.profiler: device time by
    kernel and the device's idle share of the wave's wall time. Outside
    the counted run; a profiler failure is reported, not fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            _run_wave(be, wave, card)
            torch.cuda.synchronize()
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
    log(f"[profile] {card}: profiled wave wall {wall:.3f} s, device busy "
        f"{busy_s:.3f} s (self device time summed), idle share "
        f"{max(0.0, 1 - busy_s / wall):.3f}")
    for e in rows[:15]:
        t = getattr(e, attr)
        if t <= 0:
            break
        log(f"[profile]   {t / 1e3:10.2f} ms  {e.count:7d}x  {e.key[:90]}")


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
    kern = phase_kernels()
    ref_ok = phase_reference()
    serve_ok, launches = phase_serving(card)
    serve_ok &= ref_ok
    entries = []
    for key in ("K1", "K2"):
        e = dict(kern[key])
        ok = e.pop("ok")
        e["launches"] = launches[key]
        entries.append(e)
        serve_ok &= ok
    log(f"[done] {card}: total {time.perf_counter() - t_start:.1f} s, "
        f"all phases {'PASS' if serve_ok else 'FAIL'}")
    if not serve_ok:
        return 1
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
