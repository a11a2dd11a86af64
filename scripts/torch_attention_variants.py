#!/usr/bin/env python3
"""Time versions of the port's attention kernel against each other and
against SDPA, in one process on one NVIDIA card (nobs_whisper_torch's
``csrc/encoder_attention.cu``: K3 and K9 in bf16, and K3's int8 variants).

Versions, each built from source with the port's ``nvcc`` flags into
``build/attn_variants/`` (gitignored):

* ``kernel``: the checkout's ``encoder_attention.cu``;
* ``expf``: the same source with the accurate ``expf`` in place of the
  SFU exp (``exp_sfu``) in the softmax;
* ``baseline``: another version of the file given with ``--baseline``, for
  example the parent commit's:
  ``git show HEAD~1:nobs_whisper_torch/csrc/encoder_attention.cu > build/old.cu``.

For each shape (turbo width: B = 2 windows, T = 1536, n_real = 1500) it
prints the card, each version's time (CUDA events over back-to-back calls,
timed in turns: every version in order, then in reverse order), its error
against the plain version in bf16 steps (|kernel - plain| / (2^-9 + 2^-7
|plain|), max) and SDPA's time on the same q/k/v. For the K3 int8 variants
(``nwt_encoder_attention_btd_int8``: int8 scores, int8 PV, both) the error
is the max and mean absolute one (the checks' ``VAR_TOL``), and each
version's device time is split into its attention kernel and the rest
(``int8_prep``) with torch.profiler. Last, the share of int8 probabilities
pq = rint(p 127) that the SFU exp (``ex2.approx.ftz`` of x log2 e, as the
kernel computes it) puts on another integer than the accurate ``expf``,
over the scores s - max of the K3 turbo shape's real keys (bf16 scores
and int8 scores), from a probe kernel built here.

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_attention_variants.py [--baseline build/old.cu]``.
Imports nothing of JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = (("K3", 20, 64), ("K9", 10, 128), ("K9", 20, 64), ("K9", 15, 64),
          ("K9", 40, 32))
INT8 = (("i8s", True, False), ("i8pv", False, True), ("both", True, True))
B, T, N_REAL = 2, 1536, 1500
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGS = {"nwt_encoder_attention_btd": [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P],
        "nwt_encoder_attention_bhtd": [_P] * 4 + [_I] * 5
        + [ctypes.c_float, _P],
        "nwt_encoder_attention_btd_int8": [_P] * 9 + [_I] * 4
        + [ctypes.c_float, _I, _P]}

# the SFU exp of csrc/encoder_attention.cu against expf, on x = s - max
PROBE = r"""
#include <cuda_runtime.h>
__global__ void pq_flips(const float* x, long long n,
                         unsigned long long* flips) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y) : "f"(__fmul_rn(x[i], 1.4426950408889634f)));
  const int qa = (int)rintf(__fmul_rn(expf(x[i]), 127.0f));
  const int qb = (int)rintf(__fmul_rn(y, 127.0f));
  if (qa != qb) atomicAdd(flips, 1ull);
}
extern "C" int nwt_pq_flips(const void* x, long long n, void* flips,
                            void* stream) {
  pq_flips<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (unsigned long long*)flips);
  return (int)cudaGetLastError();
}
"""


def build(versions):
    from nobs_whisper_torch.ops import _build
    out_dir = os.path.join(ROOT, "build", "attn_variants")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(ROOT, "nobs_whisper_torch", "csrc")
    procs = {}
    for name, text in versions.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
             os.path.join(out_dir, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn, argtypes in SIGS.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "nwt_pq_flips"):
            lib.nwt_pq_flips.argtypes = [_P, ctypes.c_longlong, _P, _P]
            lib.nwt_pq_flips.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def split_ms(fn, reps):
    """Device ms per call of ``fn``: its attention kernel (the checkout's
    ``attn_wgmma_kernel`` or a baseline's ``attn_*``), and the rest."""
    from nobs_whisper_torch.utils.profiling import device_ms_split
    attn, rest = device_ms_split(fn, reps, "attn_")
    return attn, sum(t for _, t in rest)


def in_turns(calls, reps):
    """Each call's ms, timed in order and then in reverse order."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(cuda_ms(calls[name], reps))
    return times


def scores_minus_max(q, k, h, int8_scores, sm):
    """s - max over the real keys, (B, H, T, n_real) f32, as
    ops/encoder_attention.py::_attend computes them (int8 scores: q per
    (row, head), k per head)."""
    import torch
    from nobs_whisper_torch.ops import encoder_attention as ea
    qh = ea._heads(q, h).float()
    kh = ea._heads(k, h).float()[..., :N_REAL, :]
    if int8_scores:
        sq = torch.clamp(qh.abs().amax(-1, keepdim=True), min=1e-6) / 127.0
        qq = torch.clamp(torch.round(qh / sq), -127, 127)
        sk = ea._head_scale(kh, N_REAL)
        kq = ea._quant_by(kh, sk)
        s = (qq @ kq.transpose(-1, -2)) * (sq * (sk * sm))
    else:
        s = (qh * sm).to(torch.bfloat16).float() @ kh.transpose(-1, -2)
    return s - s.amax(-1, keepdim=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another encoder_attention.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 scores stay f32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    with open(os.path.join(ROOT, "nobs_whisper_torch", "csrc",
                           "encoder_attention.cu")) as f:
        src = f.read()
    versions = {"kernel": src,
                "expf": src.replace("exp_sfu(__fsub_rn", "expf(__fsub_rn")}
    if versions["expf"] == src:
        sys.exit("no exp_sfu call in the softmax to replace")
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
    libs = build(dict(versions, probe=PROBE))
    probe = libs.pop("probe")

    from nobs_whisper_torch.ops import encoder_attention as ea
    dev = torch.device("cuda")
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    mask = torch.zeros(1, T, device=dev, dtype=torch.bool)
    mask[:, :N_REAL] = True
    for key, h, dh in SHAPES:
        g = torch.Generator(device=dev).manual_seed(T + h + dh)
        shape = (B, T, h * dh) if key == "K3" else (B, h, T, dh)
        q, k, v = ((torch.randn(*shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16) for _ in range(3))
        sm = float(dh) ** -0.5
        if key == "K3":
            ref = ea.encoder_attention_btd_plain(q, k, v, N_REAL, sm, h)
            heads = lambda z: z.view(B, T, h, dh).transpose(1, 2)
        else:
            ref = ea.encoder_attention_plain(q, k, v, N_REAL, sm)
            heads = lambda z: z
        calls, steps = {}, {}
        for name, lib in libs.items():
            out = torch.empty_like(q)
            if key == "K3":
                fn = (lambda lib=lib, out=out: lib.nwt_encoder_attention_btd(
                    ptr(q), ptr(k), ptr(v), ptr(out), B, T, h, dh, N_REAL,
                    ctypes.c_float(sm), stream()))
            else:
                fn = (lambda lib=lib, out=out: lib.nwt_encoder_attention_bhtd(
                    ptr(q), ptr(k), ptr(v), ptr(out), B, h, T, dh, N_REAL,
                    ctypes.c_float(sm), stream()))
            if fn() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            steps[name] = (diff / (2.0 ** -9 + 2.0 ** -7 * ref.float().abs())
                           ).max().item()
            calls[name] = fn
        times = in_turns(calls, args.reps)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=mask, scale=sm),
            args.reps)
        print(f"[variants] {key} B={B} T={T} H={h} dh={dh} n_real={N_REAL}: "
              + "; ".join(f"{n} {times[n][0]:.4f}/{times[n][1]:.4f} ms "
                          f"({steps[n]:.3f} steps)" for n in calls)
              + f"; SDPA {sdpa:.4f} ms", flush=True)

    # K3's int8 variants: each version's whole call (int8_prep + attention)
    h, dh = 20, 64
    d = h * dh
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v = ((torch.randn(B, T, d, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(3))
    sm = 0.125
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        *(z.view(B, T, h, dh).transpose(1, 2) for z in (q, k, v)),
        attn_mask=mask, scale=sm), args.reps)
    # workspace by bytes: every version's int8_prep lays out its own
    ws = [torch.empty(B * T * d, dtype=torch.int8, device=dev),
          torch.empty(B * T * h, dtype=torch.float32, device=dev),
          torch.empty(B * T * d, dtype=torch.int8, device=dev),
          torch.empty(B * T * d, dtype=torch.int8, device=dev),
          torch.empty(2 * B * h * ea.AMAX_PARTS, dtype=torch.int32,
                      device=dev)]
    for var, s8, pv in INT8:
        ref = ea.encoder_attention_btd_plain(q, k, v, N_REAL, sm, h, s8, pv)
        calls, errs, parts = {}, {}, {}
        for name, lib in libs.items():
            out = torch.empty_like(q)
            fn = (lambda lib=lib, out=out: lib.nwt_encoder_attention_btd_int8(
                ptr(q), ptr(k), ptr(v), ptr(out), *map(ptr, ws), B, T, h,
                N_REAL, ctypes.c_float(sm), int(s8) | int(pv) << 1,
                stream()))
            if fn() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            diff = (out.float() - ref.float())[:, :N_REAL].abs()
            errs[name] = (diff.max().item(), diff.mean().item())
            parts[name] = split_ms(fn, args.reps)
            calls[name] = fn
        times = in_turns(calls, args.reps)
        print(f"[variants] K3-{var} B={B} T={T} H={h} dh={dh} "
              f"n_real={N_REAL}: "
              + "; ".join(f"{n} {times[n][0]:.4f}/{times[n][1]:.4f} ms "
                          f"(attention {parts[n][0]:.4f} + int8_prep "
                          f"{parts[n][1]:.4f} device ms; max err "
                          f"{errs[n][0]:.3e} mean {errs[n][1]:.3e})"
                          for n in calls)
              + f"; SDPA {sdpa:.4f} ms", flush=True)

    # pq flips of the SFU exp against expf on the same s - max
    for what, s8 in (("bf16 scores", False), ("int8 scores", True)):
        x = scores_minus_max(q, k, h, s8, sm).contiguous()
        flips = torch.zeros(1, dtype=torch.int64, device=dev)
        if probe.nwt_pq_flips(ptr(x), x.numel(), ptr(flips), stream()):
            raise RuntimeError("probe launch failed")
        torch.cuda.synchronize()
        n = int(flips.item())
        print(f"[variants] pq = rint(p 127) with the SFU exp against expf, "
              f"{what}, K3 turbo shape: {n} of {x.numel()} probabilities "
              f"differ ({n / x.numel():.3e})", flush=True)
        del x


if __name__ == "__main__":
    main()
