#!/usr/bin/env python3
"""Time versions of the port's K5 (the int8 cross-attention decode step,
nobs_whisper_torch's ``csrc/cross_attention_decode.cu``) against each other
and against SDPA, in one process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/xattn_variants/`` (gitignored):

* ``kernel``: the checkout's ``cross_attention_decode.cu``;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source with
  those ``constexpr int`` constants changed (for example ``--tune
  K5_FORCE_C=8`` for a fixed cluster size, ``--tune K5_PV_LOADS=8`` for
  more of V's loads in flight);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the same
  source with each text OLD replaced by NEW, for ablations;
* ``baseline``: another version of the file given with ``--baseline``,
  built beside the headers of its own directory (for example
  ``tests/goldens/xattn_decode_v1.cu``, K5's first kernel, with
  ``common_v1.cuh``).

For each geometry (large-v3-turbo's 20 heads of 64 over Tp = 1536, 1500
real positions, at B = 1, 8 and 16) it prints the card, then for each
version its error against ``cross_attention_decode_q8_plain`` (max abs,
and whether it is within one bf16 step, ``chip_smoke.py``'s
``XATTN_STEP``), whether two calls give the same bits, its time back to
back (CUDA events over calls of the raw C entry, in turns: every version
in order, then in reverse order), alone on the device cold (the calls
captured in a CUDA graph over enough K/V sets to pass the 50 MB L2, as a
decode step finds each layer's cross-KV) and alone over one set (in L2),
beside the bound and SDPA on K/V dequantized to bf16 (twice K5's bytes),
cold and over one set; the checkout's plan (cluster size and slice); and
``[host]``: the host's work a call of the port's wrapper and of each
version's raw C entry (two turns, the second in reverse order).
With ``--trace`` it also builds the checkout with its ``K5_MARK`` phase
boundaries recording ``clock64`` (and ``globaltimer`` at a block's start
and end) and prints, for one cold call at each geometry, each phase's
mean and largest cycles over the blocks, and when blocks start and end.

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
``python3 scripts/torch_xattn_variants.py [--baseline FILE]
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
# the traced build: K5_MARK(i) stores block-thread 0's clock64 at phase
# boundary i (0-9) and the globaltimer at the first and the last
TRACE = r"""#include <cuda_runtime.h>
__device__ unsigned long long k5_trace[1 << 16];
#define K5_MARK(i) do { if (threadIdx.x == 0) { \
  unsigned long long t_, *r_ = k5_trace + (blockIdx.y * gridDim.x + blockIdx.x) * 12; \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)); r_[i] = t_; \
  if ((i) == 0 || (i) == 9) { \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); r_[10 + ((i) == 9)] = t_; } } } while (0)
extern "C" int nwt_k5_trace(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k5_trace, (size_t)n * 8);
}
"""
PHASES = ("set up + issue loads", "wait for the scales",
          "scores + block max", "max exchange", "exp + block sum",
          "sum exchange + normalise", "PV + block sum", "partial exchange",
          "output")


def main():
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
                     help="time the knob path's decode step end to end")
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
        versions["trace"] = TRACE + src
    libs, logs = _build.build_variants(
        versions, out_dir, dict(ap._SIG, nwt_k5_trace=[ctypes.c_void_p,
                                                       ctypes.c_int]))
    traced = libs.pop("trace", None)
    for name, text in logs.items():
        for line in text.splitlines():
            if ("xattn_q8" in line or "Used" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scale = ctypes.c_float(float(DH) ** -0.5)
    for b in BATCHES:
        g = torch.Generator(device=dev).manual_seed(30 + b)
        q = (torch.randn(b, H, 1, DH, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        tp = -(-T // 128) * 128
        nbytes = b * H * tp * (2 * DH + 8) + b * H * DH * (2 + 4)
        sets = []
        for _ in range(max(1, -(-2 * L2_BYTES // nbytes))):
            k = torch.randn(1, b, H, T, DH, generator=g, device=dev)
            v = torch.randn(1, b, H, T, DH, generator=g, device=dev)
            kq, vq = ap.quantize_cross_kv((k, v))
            kq = {z: w[0].contiguous() for z, w in kq.items()}
            vq = {z: w[0].contiguous() for z, w in vq.items()}
            sets.append((kq, vq))
            del k, v
        n = len(sets)
        ref = ap.cross_attention_decode_q8_plain(q, *sets[0])
        calls, colds, warms, notes = {}, {}, {}, {}
        for name, lib in libs.items():
            outs = [torch.empty(b, H, 1, DH, device=dev) for _ in range(n)]

            def call(i=0, lib=lib, outs=outs, name=name):
                kq, vq = sets[i]
                if lib.nwt_xattn_decode_q8(
                        ptr(q), ptr(kq["q"]), ptr(kq["s"]), ptr(vq["q"]),
                        ptr(vq["s"]), ptr(outs[i]), b * H, DH, tp, scale,
                        stream()):
                    raise RuntimeError(f"{name}: launch failed")

            call()
            torch.cuda.synchronize()
            first = outs[0].clone()
            call()
            torch.cuda.synchronize()
            same = bool(torch.equal(first, outs[0]))
            diff = (first - ref).abs()
            steps = (diff / (XATTN_STEP["atol"] + XATTN_STEP["rtol"]
                             * ref.abs())).max().item()
            notes[name] = (f"err {diff.max().item():.3e} "
                           f"{'ok' if steps <= 1.0 else 'FAIL'} ({steps:.3f} "
                           f"bf16 steps), "
                           f"{'same bits' if same else 'bits differ'}")
            calls[name] = call
            colds[name] = lambda call=call: [call(i) for i in range(n)]
            warms[name] = call
        times = in_turns(calls, args.reps)
        cold = {v: graph_ms(colds[v], args.reps) / n for v in calls}
        warm = {v: graph_ms(warms[v], args.reps) for v in calls}
        dq = []
        for kq, vq in sets:
            kh = (kq["q"].float() * kq["s"][:, :, None, :]).transpose(
                -1, -2).to(torch.bfloat16).contiguous()
            vh = (vq["q"].float() * vq["s"][..., None]).to(torch.bfloat16)
            dq.append((kh, vh, kq["s"][:, :, None, :] > 0))
        sdpa = lambda z: F.scaled_dot_product_attention(
            q, z[0], z[1], attn_mask=z[2], scale=float(DH) ** -0.5)
        lib_ms = cuda_ms(lambda: sdpa(dq[0]), args.reps)
        lib_cold = graph_ms(lambda: [sdpa(z) for z in dq], args.reps) / n
        lib_warm = graph_ms(lambda: sdpa(dq[0]), args.reps)
        del dq
        bound = nbytes / PEAK_BYTES * 1e3
        c, s = ap.k5_plan(b * H, tp, sms, DH)
        print(f"[variants] K5 B={b} H={H} Dh={DH} Tp={tp} ({n} K/V sets "
              f"cold; the checkout's plan C={c}, slices of {s}): "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms "
                          f"back to back, alone {cold[v]:.4f} cold, "
                          f"{warm[v]:.4f} over one set ({notes[v]})"
                          for v in calls)
              + f"; bound {bound:.4f} (bytes, {nbytes / 1e6:.2f} MB); SDPA "
              f"on bf16-dequantized K/V {lib_ms:.4f} back to back, alone "
              f"{lib_cold:.4f} cold, {lib_warm:.4f} over one set",
              flush=True)
        # the host's work a call (host clock over calls that enqueue
        # without waiting, in turns as above): the port's wrapper and each
        # version's raw C entry
        kq0, vq0 = sets[0]
        fns = {"the port's wrapper":
               lambda: ap.cross_attention_decode_q8(q, kq0, vq0)}
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
        print(f"[host] K5 B={b}: " + ", ".join(
            f"{w} {us[0]:.1f}/{us[1]:.1f} us a call"
            for w, us in host.items()), flush=True)
        if traced is not None:
            trace_phases(traced, q, sets, b, tp, scale, ptr, stream, c)
        del sets


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


def trace_phases(lib, q, sets, b, tp, scale, ptr, stream, c):
    """One cold call of the traced build (the last K/V set, after a call
    on the first): each phase's mean and largest cycles over the blocks
    that hold positions, and the spread of their start and end times."""
    import numpy as np
    import torch
    out = torch.empty(b, H, 1, DH, device=q.device)
    for kq, vq in (sets[0], sets[-1]):
        if lib.nwt_xattn_decode_q8(ptr(q), ptr(kq["q"]), ptr(kq["s"]),
                                   ptr(vq["q"]), ptr(vq["s"]), ptr(out),
                                   b * H, DH, tp, scale, stream()):
            raise RuntimeError("trace: launch failed")
    torch.cuda.synchronize()
    blocks = c * b * H
    raw = np.zeros(blocks * 12, dtype=np.uint64)
    if lib.nwt_k5_trace(raw.ctypes.data, blocks * 12):
        raise RuntimeError("trace: copy failed")
    t = raw.reshape(blocks, 12).astype(np.int64)
    d = np.diff(t[:, :10], axis=1)
    start, end = (t[:, 10] - t[:, 10].min()) / 1e3, (t[:, 11] - t[:, 10].min()) / 1e3
    print(f"[trace] K5 B={b} C={c} ({blocks} blocks), cycles a block, mean "
          "/ max: " + "; ".join(f"{name} {d[:, i].mean():.0f} / "
                                f"{d[:, i].max():.0f}"
                                for i, name in enumerate(PHASES))
          + f"; whole block {(t[:, 9] - t[:, 0]).mean():.0f} / "
          f"{(t[:, 9] - t[:, 0]).max():.0f}; blocks start over "
          f"{start.max():.2f} us (median {np.median(start):.2f}), end "
          f"{end.min():.2f} - {end.max():.2f} us after the first start",
          flush=True)


if __name__ == "__main__":
    main()
