#!/usr/bin/env python3
"""Time versions of the port's K6 (the int8 dequantizing matmul,
nobs_whisper_torch's ``csrc/q8_matmul.cu``) against each other and
against ``torch.matmul``, in one process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/q8_variants/`` (gitignored):

* ``kernel``: the checkout's ``q8_matmul.cu``;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source (with
  ``q8_decode.cuh`` inlined, so its constants and text count too) with
  those ``constexpr int`` constants changed (for example
  ``--tune DSTAGES=4`` or ``--tune PBK=32,PSTAGES=3``);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the
  same source with each text OLD replaced by NEW, for ablations (for
  example the weight's loads taken out, to see what the rest costs);
* ``baseline``: another version of the file given with ``--baseline``, for
  example the parent commit's
  (``git show HEAD~1:nobs_whisper_torch/csrc/q8_matmul.cu > build/old.cu``).
  A baseline whose C entry wants its output "zeroed by the caller" (the
  split-K atomics of the port's first K6) gets it zeroed before every
  call, as its wrapper did, and the memset is part of its time.

For each shape of ``chip_smoke.py``'s K6 checks (the logit projection
1280 x 51,866 at M = 8 with f32 and bf16 x, at M = 24 with f32 x and at
M = 256; fc1 1280 x 5120 and fc2 5120 x 1280 at M = 8 with both x types;
fc2 at M = 24, the prefill kernel's cluster sum) and the decode kernel's
edges (M = 1, 16, 17 at the logit shape) it prints the card, and for each
version its error against ``q8_matmul_plain`` (max abs, and whether it
is within ``K6_TOL``), whether two calls give the same bits, its time
back to back (CUDA events over calls of the raw C entry, in turns: every
version in order, then in reverse order) and alone on the device (the
calls captured in a CUDA graph over enough weight sets to pass the 50 MB
L2, replayed), beside the bound and ``torch.matmul`` of bf16 x with the weight
dequantized to bf16 before timing. For the checkout it also prints the
port wrapper's (``ops/quant.py::q8_matmul``) host time per call (host
clock over calls that enqueue without waiting) and its back-to-back time.
Then ``[host]``: what a launch costs the host, part by part (the stream
query, ``torch.empty``, the pointers, finding the entry point, the raw C
entry, the wrapper), on a shape so small that the card never paces the
host. ``[probe]``: the
weight read alone at the logit shape, with no dequantization or tensor
work (a cp.async ring over 64-row slabs in tiles of 128 and 256
columns), and the same bytes read in order: what the card's memory gives
this access pattern. Last, the opcode counts of each kernel in the
checkout's library (``cuobjdump -sass``; ``--sass FILE`` writes the whole
listing).

With ``--wide`` it times instead the rows of a serving decode step past
16 (M = 17, 24, 31, 32, bf16 x) at the decoder's four shapes, and stops
after them: with ``--baseline`` the parent's file, whose prefill kernel
took those rows, against the checkout's decode kernel.

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_q8_variants.py [--baseline build/old.cu]
[--tune NAME=VALUE ...] [--edit LABEL@@OLD@@NEW ...] [--sass FILE]
[--wide]``.
Imports nothing of JAX.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (what, M, K, N, x dtype name)
SHAPES = (("logits", 8, 1280, 51866, "f32"),
          ("logits", 8, 1280, 51866, "bf16"),
          ("fc1", 8, 1280, 5120, "bf16"), ("fc1", 8, 1280, 5120, "f32"),
          ("fc2", 8, 5120, 1280, "bf16"), ("fc2", 8, 5120, 1280, "f32"),
          ("logits", 1, 1280, 51866, "bf16"),
          ("logits", 16, 1280, 51866, "bf16"),
          ("logits", 17, 1280, 51866, "bf16"),
          ("logits", 24, 1280, 51866, "f32"),
          ("fc2", 24, 5120, 1280, "bf16"),
          ("logits", 256, 1280, 51866, "bf16"))
# --wide: the rows of a serving decode step past 16, at the decoder's four
# shapes (q, k, v, o, xq, xo; fc1; fc2; the logits)
WIDE_SHAPES = tuple((what, m, k, n, "bf16") for m in (17, 24, 31, 32)
                    for what, k, n in (("proj", 1280, 1280),
                                       ("fc1", 1280, 5120),
                                       ("fc2", 5120, 1280),
                                       ("logits", 1280, 51866)))
K6_TOL = dict(rtol=1e-3, atol=1e-3)      # chip_smoke.py's
PEAK_BYTES, PEAK_BF16_FLOPS = 3.35e12, 989e12
L2_BYTES = 50 * 2 ** 20
_P, _I = ctypes.c_void_p, ctypes.c_int
SIG = [_P] * 4 + [_I] * 3 + [_P]
SASS_OPS = ("I2F", "F2F", "F2FP", "LOP3", "HFMA2", "HADD2", "HMUL2", "PRMT", "SHF",
            "FMUL", "LDS", "STS", "LDGSTS", "LDSM", "HMMA", "BAR", "SHFL")


# the read alone: the decode kernel's cp.async ring over 64-row slabs of a
# (K, N) int8 weight in tiles of TW columns, each slab folded into one word
# (no dequantization, no tensor work), at the logit shape
PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int TW, int STAGES>
__global__ void __launch_bounds__(256) stream_probe(const int8_t* w, int K,
                                                    int N, unsigned* out) {
  extern __shared__ __align__(16) uint8_t raw[];
  constexpr int CH = TW / 16 + 1, ROWB = 16 * CH;
  const int n0 = blockIdx.x * TW, tid = threadIdx.x;
  const uintptr_t wb = (uintptr_t)w, wend = wb + (size_t)K * N;
  const int nst = (K + 63) / 64;
  auto load = [&](int st) {
    if (st < nst)
      for (int u = tid; u < 64 * CH; u += 256) {
        const int r = u / CH, ch = u % CH, k = st * 64 + r;
        const uintptr_t src = ((wb + (size_t)k * N + n0) & ~uintptr_t(15)) + 16 * ch;
        if (k < K && src < wend) {
          const unsigned d = (unsigned)__cvta_generic_to_shared(
              raw + (st % STAGES) * 64 * ROWB + r * ROWB + 16 * ch);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
        }
      }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int st = 0; st < STAGES - 1; ++st) load(st);
  unsigned acc = 0;
  for (int it = 0; it < nst; ++it) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    load(it + STAGES - 1);
    const uint8_t* s = raw + (it % STAGES) * 64 * ROWB;
    for (int e = tid; e < 64 * ROWB / 16; e += 256) {
      const uint4 v = ((const uint4*)s)[e];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  atomicXor(out, acc);
}
template <int TW, int STAGES>
static int run(const void* w, int K, int N, void* out, void* st) {
  const int smem = STAGES * 64 * (16 * (TW / 16 + 1));
  cudaFuncSetAttribute(stream_probe<TW, STAGES>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stream_probe<TW, STAGES><<<(N + TW - 1) / TW, 256, smem, (cudaStream_t)st>>>(
      (const int8_t*)w, K, N, (unsigned*)out);
  return (int)cudaGetLastError();
}
// the same bytes read in order, 16 bytes a thread, 4 loads in flight
__global__ void __launch_bounds__(256) flat_probe(const uint4* w, size_t n16,
                                                  unsigned* out) {
  unsigned acc = 0;
  const size_t step = (size_t)gridDim.x * 256;
  size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  for (; i + 3 * step < n16; i += 4 * step) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldcs(w + i + j * step);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
  }
  for (; i < n16; i += step) acc ^= __ldcs(w + i).x;
  atomicXor(out, acc);
}
extern "C" int nwt_flat_probe(const void* w, long long bytes, void* out,
                              void* st) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  flat_probe<<<sms * 8, 256, 0, (cudaStream_t)st>>>(
      (const uint4*)w, (size_t)bytes / 16, (unsigned*)out);
  return (int)cudaGetLastError();
}
extern "C" int nwt_stream_probe(const void* w, int K, int N, void* out,
                                int tw, int stages, void* st) {
  if (tw == 128 && stages == 4) return run<128, 4>(w, K, N, out, st);
  if (tw == 256 && stages == 4) return run<256, 4>(w, K, N, out, st);
  return 1;
}
"""
PROBES = ((128, 4), (256, 4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another q8_matmul.cu")
    ap.add_argument("--tune", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: constants of a variant")
    ap.add_argument("--edit", action="append", default=[],
                    help="LABEL@@OLD@@NEW[@@OLD@@NEW...]: a variant with "
                         "each text OLD of the checkout's source replaced "
                         "by NEW (an ablation; its error check may fail)")
    ap.add_argument("--wide", action="store_true",
                    help="time M = 17, 24, 31, 32 at the decoder's shapes "
                         "instead, and skip the host and probe lines")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--sass", help="write the checkout's SASS to this file")
    args = ap.parse_args()
    import torch
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.utils.profiling import cuda_ms, graph_ms, in_turns
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    csrc = os.path.join(ROOT, "nobs_whisper_torch", "csrc")
    with open(os.path.join(csrc, "q8_matmul.cu")) as f:
        src = f.read()
    # the decode header inlined, so that --tune and --edit reach it too
    with open(os.path.join(csrc, "q8_decode.cuh")) as f:
        src = src.replace('#include "q8_decode.cuh"', f.read())
    versions = {"kernel": src}
    for spec in args.tune:
        text = src
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {int(value)};", text)
            if n != 1:
                sys.exit(f"no constant {name} in q8_matmul.cu or "
                         "q8_decode.cuh")
        versions[spec.replace(",", "+")] = text
    for spec in args.edit:
        label, *pairs = spec.split("@@")
        text = src
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                sys.exit(f"{label}: text not found in q8_matmul.cu or "
                         "q8_decode.cuh")
            text = text.replace(old, new)
        versions[label] = text
    zeroed = set()
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
        if "be zeroed by the caller" in versions["baseline"]:
            zeroed.add("baseline")
    out_dir = os.path.join(ROOT, "build", "q8_variants")
    libs, logs = _build.build_variants(
        dict(versions, probe=PROBE), out_dir,
        {"nwt_q8_matmul_bf16": SIG, "nwt_q8_matmul_f32": SIG,
         "nwt_stream_probe": [_P, _I, _I, _P, _I, _I, _P],
         "nwt_flat_probe": [_P, ctypes.c_longlong, _P, _P]})
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)
    probe = libs.pop("probe")

    from nobs_whisper_torch.ops import quant as qt
    dev = torch.device("cuda")
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for what, m, k, n, xdt in WIDE_SHAPES if args.wide else SHAPES:
        g = torch.Generator(device=dev).manual_seed(40 + m + n)
        x = torch.randn(m, k, generator=g, device=dev).to(dtypes[xdt])
        sets = max(1, -(-2 * L2_BYTES // (k * n)))
        ws = [qt.quantize_int8(torch.randn(k, n, generator=g, device=dev)
                               * k ** -0.5) for _ in range(sets)]
        w = ws[0]
        ref = qt.q8_matmul_plain(x, w)
        entry = "nwt_q8_matmul_f32" if xdt == "f32" else "nwt_q8_matmul_bf16"
        calls, graphs, notes = {}, {}, {}
        for name, lib in libs.items():
            fn = getattr(lib, entry)
            outs = [torch.empty(m, n, device=dev) for _ in range(sets)]

            def call(i=0, fn=fn, outs=outs, name=name):
                if name in zeroed:
                    outs[i].zero_()
                if fn(ptr(x), ptr(ws[i]["q"]), ptr(ws[i]["s"]), ptr(outs[i]),
                      m, k, n, stream()):
                    raise RuntimeError(f"{name}: launch failed")

            call()
            torch.cuda.synchronize()
            first = outs[0].clone()
            call()
            torch.cuda.synchronize()
            same = bool(torch.equal(first, outs[0]))
            err = (first - ref).abs().max().item()
            close = bool(torch.allclose(first, ref, **K6_TOL))
            notes[name] = (f"err {err:.3e} {'ok' if close else 'FAIL'}, "
                           f"{'same bits' if same else 'bits differ'}")
            calls[name] = call
            graphs[name] = (lambda call=call: [call(i) for i in
                                               range(sets)])
        times = in_turns(calls, args.reps)
        alone = {name: graph_ms(graphs[name], args.reps) / sets
                 for name in calls}
        xb = x.to(torch.bfloat16)
        wb = [wi["q"].to(torch.bfloat16) * wi["s"].to(torch.bfloat16)
              for wi in ws]
        lib_ms = cuda_ms(lambda: torch.matmul(xb, wb[0]), args.reps)
        lib_alone = graph_ms(lambda: [torch.matmul(xb, wi) for wi in wb],
                             args.reps) / sets
        del wb
        nbytes = k * n + n * 4 + m * k * x.element_size() + m * n * 4
        tb, to = nbytes / PEAK_BYTES, 2.0 * m * k * n / PEAK_BF16_FLOPS
        bound = max(tb, to) * 1e3
        by = "bytes" if tb >= to else "operations"
        # the host time a call of the checkout's raw C entry (ctypes and the
        # launch), and of the port's wrapper, and the wrapper back to back
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            calls["kernel"]()
        raw_host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        port = lambda: qt.q8_matmul(x, w)
        port_ms = cuda_ms(port, args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            port()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"[variants] K6 {what} M={m} K={k} N={n} x {xdt} ({sets} "
              f"weight sets in the graph): "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms back "
                          f"to back, {alone[v]:.4f} alone ({notes[v]})"
                          for v in calls)
              + f"; bound {bound:.4f} ({by}); torch.matmul on bf16 weight "
              f"{lib_ms:.4f} back to back, {lib_alone:.4f} alone; the "
              f"port's wrapper {port_ms:.4f} back to back, host "
              f"{host_ms:.4f} ms a call (the raw C entry's {raw_host:.4f})",
              flush=True)
        del ws, w, x
    if args.wide:
        return

    # what a launch costs the host, by part (us a call, 2000 calls each; a
    # tiny shape, so that the card keeps up and never paces the host)
    x = torch.randn(1, 64, device=dev, dtype=torch.bfloat16)
    w = qt.quantize_int8(torch.randn(64, 128, device=dev) * 0.1)
    out = torch.empty(1, 128, device=dev)
    lib = libs["kernel"]
    cargs = [ctypes.c_void_p(z.data_ptr())
             for z in (x, w["q"], w["s"], out)]
    raw_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    parts = {
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.empty((8, 51866))":
            lambda: torch.empty((8, 51866), device=dev),
        "4 ctypes.c_void_p(data_ptr())":
            lambda: [ctypes.c_void_p(z.data_ptr())
                     for z in (x, w["q"], w["s"], out)],
        "the C entry (M=1, K=64, N=128), arguments ready":
            lambda: lib.nwt_q8_matmul_bf16(*cargs, 1, 64, 128, raw_stream),
        "the entry point from _build.load":
            lambda: _build.load("q8_matmul", qt._Q8_SIG).nwt_q8_matmul_bf16,
        "the port's wrapper (M=1, K=64, N=128)": lambda: qt.q8_matmul(x, w)}
    for what, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"[host] {what}: {us:.2f} us a call", flush=True)
    del x, w, out

    # the read alone at the logit shape, by tile width and ring depth
    k, n = 1280, 51866
    ws = [torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev)
          for _ in range(2)]
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for tw, stages in PROBES:
        fn = (lambda tw=tw, stages=stages: [probe.nwt_stream_probe(
            ptr(wi), k, n, ptr(sink), tw, stages, stream()) for wi in ws])
        if any(fn()):
            raise RuntimeError("probe launch failed")
        ms = graph_ms(fn, args.reps) / len(ws)
        print(f"[probe] read alone, logit weight {k} x {n} int8, tiles of "
              f"{tw} columns, {stages} stages: {ms:.4f} ms "
              f"({k * n / ms / 1e9:.3f} TB/s)", flush=True)
    fn = lambda: [probe.nwt_flat_probe(ptr(wi), k * n, ptr(sink), stream())
                  for wi in ws]
    if any(fn()):
        raise RuntimeError("probe launch failed")
    ms = graph_ms(fn, args.reps) / len(ws)
    print(f"[probe] read alone, the same {k * n} bytes in order: {ms:.4f} ms "
          f"({k * n / ms / 1e9:.3f} TB/s)", flush=True)
    del ws

    if args.sass:
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", os.path.join(out_dir,
                                                        "libkernel.so")],
                           stdout=f, check=True)
    for fn, ops in _build.sass_counts(os.path.join(out_dir,
                                            "libkernel.so")).items():
        print(f"[sass] {fn}: " + ", ".join(f"{op} {ops[op]}"
                                           for op in SASS_OPS if ops[op])
              + f"; {sum(ops.values())} instructions", flush=True)


if __name__ == "__main__":
    main()
