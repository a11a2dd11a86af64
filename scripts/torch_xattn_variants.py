#!/usr/bin/env python3
"""Time versions of the port's K5 (the int8 cross-attention decode step,
nobs_whisper_torch's ``csrc/cross_attention_decode.cu``), or with
``--kernel K4`` of K4 (the bf16 one, the same file), against each other
and against SDPA, in one process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/xattn_variants/`` (gitignored):

* ``kernel``: the checkout's ``cross_attention_decode.cu``;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source with
  those ``constexpr int`` constants changed (for example ``--tune
  K5_FORCE_C=8`` for a fixed cluster size, ``--tune K5_PV_LOADS=8`` for
  more of V's loads in flight; K4's ``K4_FORCE_C``, ``K4_STAGES``,
  ``K4_STAGE``);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the same
  source with each text OLD replaced by NEW, for ablations;
* ``baseline``: another version of the file given with ``--baseline``,
  built beside the headers of its own directory (for example
  ``tests/goldens/xattn_decode_v1.cu``, K4's and K5's first kernels,
  with ``common_v1.cuh``).

For each geometry (large-v3-turbo's 20 heads of 64 over Tp = 1536, 1500
real positions, at B = 1, 8 and 16) it prints the card, then for each
version its error against the kernel's plain version
(``cross_attention_decode_q8_plain`` or ``_bf16_plain``: max abs, and
whether it is within one bf16 step, ``chip_smoke.py``'s ``XATTN_STEP``),
whether two calls give the same bits and whether they are the checkout
kernel's bits, its time back to
back (CUDA events over calls of the raw C entry, in turns: every version
in order, then in reverse order), alone on the device cold (the calls
captured in a CUDA graph over enough K/V sets to pass the 50 MB L2, as a
decode step finds each layer's cross-KV) and alone over one set (in L2),
beside the bound, ``torch.sum`` over as many bf16 bytes (alone, cold: a
yardstick of the card's practical read rate) and SDPA (K5: on K/V
dequantized to bf16, twice K5's bytes; K4: on its bf16 K/V, keys past
t_real masked), cold and over one set; the checkout's plan (cluster size
and slice); and ``[host]``: the host's work a call of the port's wrapper
and of each version's raw C entry (two turns, the second in reverse
order). With ``--trace`` it also builds the checkout with its
``K5_MARK`` (or ``K4_MARK``) phase boundaries recording ``clock64`` (and
``globaltimer`` at a block's start and end, and the block's SM) and
prints, for one cold call at each geometry, each phase's mean and
largest cycles over the blocks, when blocks start and end, and how many
blocks each SM held; for K4 also ``[clusters]``, how many clusters of
each size the card holds at once.

With ``--step`` it times, instead, the decode step of K5's knob path end
to end: large-v3-turbo's decoder (4 layers, d 1280, int8 weights from a
seed, bf16 compute) over int8 cross-KV of 1500 positions, with
``NWT_Q8_KV_PALLAS=1`` and ``NWT_Q8_KERNEL_MIN_BYTES=1`` as
``chip_smoke.py``'s int8 cross-KV wave sets them (K5 once a layer, K6 on
every int8 weight): after a 3-token prefill, single-token forwards, each
step's greedy token fed to the next, on the host clock with the device
drained after each step, at B = 1 and 8, beside K5 alone through that
package's wrapper (back to back, and the host's work a call). ``--package DIR`` imports
``nobs_whisper_torch`` from DIR instead of the checkout (for example the
parent commit unpacked by ``git archive``), so that two versions of the
whole step compare on one card: run the script once for each, in turns.

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_xattn_variants.py [--kernel K4] [--baseline FILE]
[--tune NAME=VALUE ...] [--edit LABEL@@OLD@@NEW ...] [--trace]`` or
``python3 scripts/torch_xattn_variants.py --step [--package DIR]``.
Imports nothing of JAX.
"""

import argparse
import ctypes
import glob
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, DH, T = 20, 64, 1500
BATCHES = (1, 8, 16)
XATTN_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)   # chip_smoke.py's
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20
# the traced build: K5_MARK(i) and K4_MARK(i) store block-thread 0's
# clock64 at phase boundary i (0-9), the globaltimer at the first and the
# last, and the block's SM
TRACE = r"""#include <cuda_runtime.h>
__device__ unsigned long long k5_trace[1 << 17];
#define K5_MARK(i) do { if (threadIdx.x == 0) { \
  unsigned long long t_, *r_ = k5_trace + (blockIdx.y * gridDim.x + blockIdx.x) * 13; \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)); r_[i] = t_; \
  if ((i) == 0 || (i) == 9) { \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); r_[10 + ((i) == 9)] = t_; } \
  if ((i) == 0) { unsigned s_; asm volatile("mov.u32 %0, %%smid;" : "=r"(s_)); r_[12] = s_; } } } while (0)
#define K4_MARK(i) K5_MARK(i)
extern "C" int nwt_k5_trace(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k5_trace, (size_t)n * 8);
}
"""
# appended to the traced build: the most clusters of K4's kernel (Dh 64)
# the card holds at once, for cluster size c and `smem` bytes a block
TRACE_TAIL = r"""
extern "C" int nwt_k4_clusters(int c, int smem, int* out) {
  auto kernel = nwt::xattn_bf16_kernel<64>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       nwt::K4_SMEM_MAX);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1024);
  cfg.blockDim = dim3(nwt::K4_THREADS + 32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
"""
PHASES = {"K5": ("set up + issue loads", "wait for the scales",
                 "scores + block max", "max exchange", "exp + block sum",
                 "sum exchange + normalise", "PV + block sum",
                 "partial exchange", "output"),
          "K4": ("set up + issue loads", "scores (K boxes)",
                 "block max + cluster wait", "max exchange",
                 "exp + block sum", "sum exchange + normalise",
                 "PV (V boxes) + block sum", "partial exchange", "output")}


def main():
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--kernel", choices=("K5", "K4"), default="K5",
                     help="the kernel whose versions are timed")
    ap_.add_argument("--baseline", help="another cross_attention_decode.cu")
    ap_.add_argument("--tune", action="append", default=[],
                     help="NAME=VALUE[,NAME=VALUE]: constants of a variant")
    ap_.add_argument("--edit", action="append", default=[],
                     help="LABEL@@OLD@@NEW[@@OLD@@NEW...]: a variant with "
                          "each text OLD replaced by NEW")
    ap_.add_argument("--reps", type=int, default=30)
    ap_.add_argument("--trace", action="store_true",
                     help="time the checkout's phases (clock64)")
    ap_.add_argument("--step", action="store_true",
                     help="time K5's knob path's decode step end to end")
    ap_.add_argument("--package", help="the directory to import "
                                       "nobs_whisper_torch from (--step)")
    args = ap_.parse_args()
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    if args.step:
        return decode_steps(args.package or ROOT)
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.utils.profiling import cuda_ms, graph_ms, in_turns
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    key = args.kernel
    with open(os.path.join(_build.CSRC, "cross_attention_decode.cu")) as f:
        src = f.read()
    versions = {"kernel": src}
    for spec in args.tune:
        text = src
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {int(value)};", text)
            if n != 1:
                sys.exit(f"no constant {name} in cross_attention_decode.cu")
        versions[spec.replace(",", "+")] = text
    for spec in args.edit:
        label, *pairs = spec.split("@@")
        text = src
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                sys.exit(f"{label}: text not found")
            text = text.replace(old, new)
        versions[label] = text
    out_dir = os.path.join(ROOT, "build", "xattn_variants")
    os.makedirs(out_dir, exist_ok=True)
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
        for h in glob.glob(os.path.join(os.path.dirname(
                os.path.abspath(args.baseline)), "*.cuh")):
            shutil.copy(h, out_dir)
    if args.trace:
        versions["trace"] = TRACE + src + (TRACE_TAIL if key == "K4" else "")
    sigs = dict(ap._SIG, nwt_k5_trace=[ctypes.c_void_p, ctypes.c_int])
    if key == "K4" and args.trace:
        sigs["nwt_k4_clusters"] = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    libs, logs = _build.build_variants(versions, out_dir, sigs)
    traced = libs.pop("trace", None)
    kernel_name = "xattn_bf16" if key == "K4" else "xattn_q8"
    for name, text in logs.items():
        for line in text.splitlines():
            if (kernel_name in line or "Used" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tp = -(-T // 128) * 128
    if traced is not None and key == "K4":
        # how many clusters of each size the card holds at once
        # (cudaOccupancyMaxActiveClusters), at the shared memory of the
        # slice that size gives at turbo: one wave needs B x H of them
        held = []
        for c in (1, 2, 4, 8, 16):
            s = -(-(tp // ap.K4_STEP) // c) * ap.K4_STEP
            n = ctypes.c_int(0)
            err = traced.nwt_k4_clusters(
                c, ap.k4_smem(DH, min(s, ap.K4_SPAN)), ctypes.byref(n))
            held.append(f"C={c}: {n.value if err == 0 else f'error {err}'}")
        print("[clusters] K4 clusters the card holds at once: "
              + ", ".join(held), flush=True)
    for b in BATCHES:
        g = torch.Generator(device=dev).manual_seed(30 + b)
        q = (torch.randn(b, H, 1, DH, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        if key == "K4":
            # K and V of the real positions, q read, out written (f32)
            nbytes = 2 * b * H * T * DH * 2 + b * H * DH * (2 + 4)
        else:
            nbytes = b * H * tp * (2 * DH + 8) + b * H * DH * (2 + 4)
        sets = []
        for _ in range(max(1, -(-2 * L2_BYTES // nbytes))):
            k = torch.randn(1, b, H, T, DH, generator=g, device=dev)
            v = torch.randn(1, b, H, T, DH, generator=g, device=dev)
            if key == "K4":
                kd, vd = ap.pack_cross_kv_bf16((k, v))
                sets.append(({"kT": kd["kT"][0].contiguous(),
                              "v": vd["v"][0].contiguous()},))
            else:
                kq, vq = ap.quantize_cross_kv((k, v))
                sets.append(({z: w[0].contiguous() for z, w in kq.items()},
                             {z: w[0].contiguous() for z, w in vq.items()}))
            del k, v
        n = len(sets)
        if key == "K4":
            ref = ap.cross_attention_decode_bf16_plain(q, sets[0][0], T)
        else:
            ref = ap.cross_attention_decode_q8_plain(q, *sets[0])
        calls, colds, warms, notes, firsts = {}, {}, {}, {}, {}
        for name, lib in libs.items():
            outs = [torch.empty(b, H, 1, DH, device=dev) for _ in range(n)]

            def call(i=0, lib=lib, outs=outs, name=name):
                err = raw_call(lib, key, q, sets[i], outs[i], tp)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            try:
                call()
            except RuntimeError as e:   # a plan the C entry refuses
                print(f"[variants] {key} B={b}: {e}; left out", flush=True)
                continue
            torch.cuda.synchronize()
            first = firsts[name] = outs[0].clone()
            call()
            torch.cuda.synchronize()
            same = bool(torch.equal(first, outs[0]))
            diff = (first - ref).abs()
            steps = (diff / (XATTN_STEP["atol"] + XATTN_STEP["rtol"]
                             * ref.abs())).max().item()
            as_kernel = bool(torch.equal(first, firsts["kernel"]))
            notes[name] = (f"err {diff.max().item():.3e} "
                           f"{'ok' if steps <= 1.0 else 'FAIL'} ({steps:.3f} "
                           f"bf16 steps), "
                           f"{'same bits' if same else 'bits differ'}"
                           + ("" if name == "kernel" else
                              ", the kernel's bits" if as_kernel else
                              ", not the kernel's bits"))
            calls[name] = call
            colds[name] = lambda call=call: [call(i) for i in range(n)]
            warms[name] = call
        times = in_turns(calls, args.reps)
        cold = {v: graph_ms(colds[v], args.reps) / n for v in calls}
        warm = {v: graph_ms(warms[v], args.reps) for v in calls}
        lib_sets = []
        for kv in sets:
            if key == "K4":
                lib_sets.append((kv[0]["kT"].transpose(-1, -2).contiguous(),
                                 kv[0]["v"],
                                 (torch.arange(tp, device=dev) < T)[None, :]))
            else:
                kq, vq = kv
                kh = (kq["q"].float() * kq["s"][:, :, None, :]).transpose(
                    -1, -2).to(torch.bfloat16).contiguous()
                vh = (vq["q"].float() * vq["s"][..., None]).to(
                    torch.bfloat16)
                lib_sets.append((kh, vh, kq["s"][:, :, None, :] > 0))
        sdpa = lambda z: F.scaled_dot_product_attention(
            q, z[0], z[1], attn_mask=z[2], scale=float(DH) ** -0.5)
        lib_ms = cuda_ms(lambda: sdpa(lib_sets[0]), args.reps)
        lib_cold = graph_ms(lambda: [sdpa(z) for z in lib_sets],
                            args.reps) / n
        lib_warm = graph_ms(lambda: sdpa(lib_sets[0]), args.reps)
        del lib_sets
        # a yardstick of the card's practical read rate: PyTorch's sum over
        # as many bf16 bytes, alone, cold
        flat = [torch.randn(nbytes // 2, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(n)]
        read_ms = graph_ms(lambda: [z.sum() for z in flat], args.reps) / n
        del flat
        bound = nbytes / PEAK_BYTES * 1e3
        c, s = (ap.k4_plan(b * H, tp, sms) if key == "K4" else
                ap.k5_plan(b * H, tp, sms, DH))
        lib_what = ("SDPA on bf16 K/V, keys past t_real masked" if key == "K4"
                    else "SDPA on bf16-dequantized K/V")
        print(f"[variants] {key} B={b} H={H} Dh={DH} Tp={tp} t_real={T} "
              f"({n} K/V sets cold; the checkout's plan C={c}, slices of "
              f"{s}, {c * b * H} blocks): "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms "
                          f"back to back, alone {cold[v]:.4f} cold, "
                          f"{warm[v]:.4f} over one set ({notes[v]})"
                          for v in calls)
              + f"; bound {bound:.4f} (bytes, {nbytes / 1e6:.2f} MB; "
              f"torch.sum over as many bytes, alone, cold {read_ms:.4f}, "
              f"{nbytes / read_ms / 1e9:.2f} TB/s); "
              f"{lib_what} {lib_ms:.4f} back to back, alone "
              f"{lib_cold:.4f} cold, {lib_warm:.4f} over one set",
              flush=True)
        # the host's work a call (host clock over calls that enqueue
        # without waiting, in turns as above): the port's wrapper and each
        # version's raw C entry
        if key == "K4":
            wrapper = lambda: ap.cross_attention_decode_bf16(q, sets[0][0], T)
        else:
            wrapper = lambda: ap.cross_attention_decode_q8(q, *sets[0])
        fns = {"the port's wrapper": wrapper}
        fns.update((f"{v}'s raw C entry", calls[v]) for v in calls)
        host = {w: [] for w in fns}
        for order in (list(fns), list(fns)[::-1]):
            for what in order:
                fns[what]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fns[what]()
                host[what].append((time.perf_counter() - t0) / 50 * 1e6)
                torch.cuda.synchronize()
        print(f"[host] {key} B={b}: " + ", ".join(
            f"{w} {us[0]:.1f}/{us[1]:.1f} us a call"
            for w, us in host.items()), flush=True)
        if traced is not None:
            trace_phases(traced, key, q, sets, tp, b, c)
        del sets


def raw_call(lib, key, q, kv, out, tp):
    """``lib``'s C entry of ``key`` on one K/V set (K4: (packed,); K5: (kq,
    vq)) into ``out``, on the current stream; its error code."""
    import torch
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    b = q.shape[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scale = ctypes.c_float(float(DH) ** -0.5)
    if key == "K4":
        return lib.nwt_xattn_decode_bf16(
            ptr(q), ptr(kv[0]["kT"]), ptr(kv[0]["v"]), ptr(out), b * H, DH,
            tp, T, scale, stream)
    kq, vq = kv
    return lib.nwt_xattn_decode_q8(
        ptr(q), ptr(kq["q"]), ptr(kq["s"]), ptr(vq["q"]), ptr(vq["s"]),
        ptr(out), b * H, DH, tp, scale, stream)


def decode_steps(where, steps=100, warmup=10):
    """The knob path's decode step (module docstring, ``--step``): ms a
    step, median and mean over ``steps`` steps after ``warmup``, the K5
    and K6 launches a step, and K5 alone through the package's wrapper on
    one layer's cross-KV (back to back, and the host's work a call)."""
    import dataclasses
    import statistics
    import torch
    from nobs_whisper_torch.core.config import CONFIGS
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import quant as qt
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.profiling import cuda_ms
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    os.environ["NWT_Q8_KV_PALLAS"] = "1"
    os.environ["NWT_Q8_KERNEL_MIN_BYTES"] = "1"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}; package {os.path.relpath(mw.__file__, ROOT)}",
          flush=True)
    dev, dt = torch.device("cuda"), torch.bfloat16
    # the encoder's weights are not used: one layer of them is drawn
    cfg = dataclasses.replace(CONFIGS["large-v3-turbo"], n_audio_layer=1)
    params = quantize_decoder_params(mw.init_params(0, cfg, dtype=dt,
                                                    device=dev))
    for b in (1, 8):
        g = torch.Generator(device=dev).manual_seed(40 + b)
        xa = torch.randn(b, cfg.n_audio_ctx, cfg.n_audio_state, generator=g,
                         device=dev).to(dt)
        cross = mw.precompute_cross_kv_q8(params, xa, cfg)
        cache = mw.init_kv_cache(cfg, b, dtype=dt, device=dev)
        pad = torch.zeros(b, dtype=torch.long, device=dev)
        prompt = torch.tensor([[cfg.sot, cfg.lang_base, cfg.transcribe]] * b,
                              device=dev)
        logits, cache = mw.decoder_forward(params, prompt, 0, pad, cache,
                                           cross, cfg, dt)
        tok = logits[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        # K5 alone through the package's wrapper on layer 0's cross-KV:
        # back to back (CUDA events) and the host's work a call
        q = torch.randn(b, cfg.n_text_head, 1, cfg.head_dim, generator=g,
                        device=dev).to(dt)
        kq0 = {z: w[0] for z, w in cross[0].items()}
        vq0 = {z: w[0] for z, w in cross[1].items()}
        k5 = lambda: ap.cross_attention_decode_q8(q, kq0, vq0)
        b2b = cuda_ms(k5, reps=50)
        t0 = time.perf_counter()
        for _ in range(50):
            k5()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        times = []
        k5, k6 = ap.k5_launch_count, qt.k6_launch_count
        for i in range(warmup + steps):
            if i == warmup:
                k5, k6 = ap.k5_launch_count, qt.k6_launch_count
            t0 = time.perf_counter()
            logits, cache = mw.decoder_forward(params, tok, 3 + i, pad,
                                               cache, cross, cfg, dt)
            tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times = times[warmup:]
        print(f"[step] B={b}: {statistics.median(times):.3f} ms a step "
              f"(median of {steps}; mean {statistics.mean(times):.3f}, min "
              f"{min(times):.3f}); launches a step K5 "
              f"{(ap.k5_launch_count - k5) / steps:g}, K6 "
              f"{(qt.k6_launch_count - k6) / steps:g}; K5 through the "
              f"wrapper {b2b:.4f} ms back to back, host {host_us:.1f} us a "
              f"call", flush=True)
        del cross, cache


def trace_phases(lib, key, q, sets, tp, b, c):
    """One cold call of the traced build (the last K/V set, after a call
    on the first): each phase's mean and largest cycles over the blocks,
    the spread of their start and end times, and the blocks an SM held."""
    import numpy as np
    import torch
    out = torch.empty(b, H, 1, DH, device=q.device)
    for kv in (sets[0], sets[-1]):
        if raw_call(lib, key, q, kv, out, tp):
            raise RuntimeError("trace: launch failed")
    torch.cuda.synchronize()
    blocks = c * b * H
    raw = np.zeros(blocks * 13, dtype=np.uint64)
    if lib.nwt_k5_trace(raw.ctypes.data, blocks * 13):
        raise RuntimeError("trace: copy failed")
    t = raw.reshape(blocks, 13).astype(np.int64)
    per_sm = np.bincount(t[:, 12])
    per_sm = per_sm[per_sm > 0]
    d = np.diff(t[:, :10], axis=1)
    start, end = (t[:, 10] - t[:, 10].min()) / 1e3, (t[:, 11] - t[:, 10].min()) / 1e3
    print(f"[trace] {key} B={b} C={c} ({blocks} blocks), cycles a block, "
          "mean / max: " + "; ".join(f"{name} {d[:, i].mean():.0f} / "
                                     f"{d[:, i].max():.0f}"
                                     for i, name in enumerate(PHASES[key]))
          + f"; whole block {(t[:, 9] - t[:, 0]).mean():.0f} / "
          f"{(t[:, 9] - t[:, 0]).max():.0f}; blocks start over "
          f"{start.max():.2f} us (median {np.median(start):.2f}), end "
          f"{end.min():.2f} - {end.max():.2f} us after the first start; "
          f"{len(per_sm)} SMs hold blocks, {per_sm.min()} - {per_sm.max()} "
          f"each", flush=True)


if __name__ == "__main__":
    main()
