#!/usr/bin/env python3
"""Time versions of the port's K1 and K12 (the int8 encoder's attention
kernel with its q/k/v projections, and the whole int8 layer:
nobs_whisper_torch's ``csrc/encoder_attention.cu`` and
``csrc/fused_layer.cu``) against each other and against their library
yardstick, in one process on one NVIDIA card.

Versions, each a copy of a ``csrc/`` directory built with the port's
``nvcc`` flags into ``build/k1_variants/<version>/`` (gitignored), one
library each from its ``fused_layer.cu``, which holds both C entries:

* ``kernel``: the checkout's ``csrc/``;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same with those
  ``constexpr int`` constants changed, in whichever file declares each
  (for example ``--tune K10_BN=256``);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the same
  with each text OLD replaced by NEW in the files that hold it (its bits
  may then differ);
* ``one-set``: the checkout with the o projection's one-slab chunks on
  fc2's general path, one int32 set a tile, its products stopped at
  every flush, in place of the two halves in turn;
* ``q-apart``: the checkout with K1's q/k/v under the int8 scores as two
  launches (q alone in f32, then k and v in bf16) instead of one launch
  whose q has its own output type;
* ``baseline``: another ``csrc/`` directory given with ``--baseline``,
  for the parent commit's: ``mkdir -p build/old && git archive HEAD~1
  nobs_whisper_torch/csrc | tar -x -C build/old``, then ``--baseline
  build/old/nobs_whisper_torch/csrc``. A version without
  ``proj_wgmma.cuh`` (the port's first, mma.sync projections) takes the
  weights in the reference's (d_in, d_out) layout; the others take their
  K-major copies, made once before timing.

At large-v3-turbo width (d = 1280, 20 heads of 64, ffn 5120, K12's chunk
1280) for a batch of two windows (B = 2, T = 1536, M = 3072) and one
(M = 1536), n_real = 1500, for K1, its int8 variants, K1 with the o
projection fused and K12, it prints the card, and for each version its
error against the plain version (max abs), whether two calls give the same
bits and whether they are the checkout's, its time back to back (CUDA
events over calls of the raw C entry, in turns: every version in order,
then in reverse), alone on the device (the call captured in a CUDA graph)
and its device time by part (``torch.profiler``: ln_quant, the q/k/v GEMM,
int8_prep, attention, the o quantization and the o GEMM, K12's fc1 and
fc2), beside the bound and the yardstick (SDPA plus ``torch._int_mm`` of
the projections on the weights' K-major copies). Last, each version's
registers, spills and ptxas's performance notes (``-Xptxas -v``) and the
opcode counts of the GEMM kernels (``cuobjdump -sass``: IGMMA is the int8
``wgmma``, IMMA the int8 ``mma.sync``).

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_k1_variants.py [--baseline DIR] [--tune
NAME=VALUE ...] [--edit LABEL@@OLD@@NEW ...]``. Imports nothing of JAX.
"""

import argparse
import concurrent.futures
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
CSRC = os.path.join(ROOT, "nobs_whisper_torch", "csrc")

B_ROWS = (2, 1)                  # windows a batch: M = 3072, 1536
H, T, D, F, BLOCK_F, N_REAL = 20, 1536, 1280, 5120, 1280, 1500
# (name, K12, flags: 1 int8 scores, 2 int8 PV, 4 the o projection fused)
CASES = (("K1", False, 0), ("K1-i8s", False, 1), ("K1-i8pv", False, 2),
         ("K1-i8s-i8pv", False, 3), ("K1-o", False, 4), ("K12", True, 4))
TOL = {"K1": 2e-2, "K1-i8s": 2e-2, "K1-i8pv": 2e-2, "K1-i8s-i8pv": 2e-2,
       "K1-o": 5e-2, "K12": 1e-1}     # chip_smoke.py's
PEAK_BYTES, PEAK_INT8_OPS, PEAK_BF16_FLOPS = 3.35e12, 1979e12, 989e12
SASS_OPS = ("IGMMA", "HGMMA", "IMMA", "HMMA", "UTMALDG", "UTMASTG", "STG",
            "LDG", "STS", "LDS", "BAR")
# the o projection on fc2's general path (one accumulator set)
ONE_SET = ("a.block_f == G8_BK ? mlp_fc2_kernel<T, true>",
           "false ? mlp_fc2_kernel<T, true>")
# K1's int8-scores projections as two launches of the same kernel
Q_APART = (
    "  e = s8 ? launch_qkv_proj<bf16, false, float>(xq, sx, wq, sq, bq, wk, "
    "sk,\n                                               wv, sv, bv, q, k, v, "
    "1.0f, M,\n                                               d, st)\n",
    "  e = s8 ? q_apart(xq, sx, wq, sq, bq, wk, sk, wv, sv, bv, q, k, v, M, "
    "d, st)\n",
    "inline cudaError_t encoder_attention_fused_qkv(",
    """inline cudaError_t q_apart(const void* xq, const void* sx,
                           const void* wq, const void* sq, const void* bq,
                           const void* wk, const void* sk, const void* wv,
                           const void* sv, const void* bv, void* q, void* k,
                           void* v, int M, int d, cudaStream_t st) {
  ProjMaps mq = {}, mkv = {};
  if (!g8_map(&mq.a, xq, d, M, d, 128) || !g8_map(&mkv.a, xq, d, M, d, 128) ||
      !g8_map(&mq.w[0], wq, d, d, d, 128) ||
      !proj_map<float>(&mq.out[0], q, d, M) ||
      !g8_map(&mkv.w[0], wk, d, d, d, 128) ||
      !g8_map(&mkv.w[1], wv, d, d, d, 128) ||
      !proj_map<bf16>(&mkv.out[0], k, d, M) ||
      !proj_map<bf16>(&mkv.out[1], v, d, M))
    return cudaErrorInvalidValue;
  const float* f = nullptr;
  const ProjArgs aq = {static_cast<const float*>(sx),
                       {static_cast<const float*>(sq), f, f},
                       {static_cast<const float*>(bq), f, f}, 1.0f, M, d, 1};
  const ProjArgs akv = {static_cast<const float*>(sx),
                        {static_cast<const float*>(sk),
                         static_cast<const float*>(sv), f},
                        {f, static_cast<const float*>(bv), f}, 1.0f, M, d, 2};
  cudaError_t e = launch_proj<float, 128, false>(mq, aq, st);
  return e != cudaSuccess ? e : launch_proj<bf16, 128, false>(mkv, akv, st);
}

inline cudaError_t encoder_attention_fused_qkv(""")


def sources(src_dir):
    """{file name: text} of a csrc directory's .cu and .cuh files."""
    out = {}
    for path in sorted(glob.glob(os.path.join(src_dir, "*.cu*"))):
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


def tuned(files, spec):
    files = dict(files)
    for item in spec.split(","):
        name, value = item.split("=")
        pat = rf"(constexpr int [^;]*\b{name} = )\d+"
        hits = [n for n, t in files.items() if re.search(pat, t)]
        if len(hits) != 1:
            sys.exit(f"constant {name} found in {hits or 'no file'}")
        files[hits[0]] = re.sub(pat, rf"\g<1>{int(value)}", files[hits[0]])
    return files


def edited(files, pairs, label):
    files = dict(files)
    for old, new in zip(pairs[::2], pairs[1::2]):
        hits = [n for n, t in files.items() if old in t]
        if not hits:
            sys.exit(f"{label}: text not found in csrc/")
        for n in hits:
            files[n] = files[n].replace(old, new)
    return files


def build(versions, out_dir):
    """Build every version's fused_layer.cu in a directory of its own
    beside its copies of the other sources, which its quoted includes find
    first; returns ({name: library}, {name: nvcc's output}, {name: path})."""
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    sig = dict(ea._SIG, **fl._SIG)
    jobs = {}
    for name, files in versions.items():
        vdir = os.path.join(out_dir, name)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for fname, text in files.items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        jobs[name] = ({f"v_{name}": files["fused_layer.cu"]}, vdir)
    libs, logs, paths = {}, {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(_build.build_variants, src, d, sig)
                for name, (src, d) in jobs.items()}
        for name, fut in futs.items():
            lib, log = fut.result()
            libs[name], logs[name] = lib[f"v_{name}"], log[f"v_{name}"]
            paths[name] = os.path.join(jobs[name][1], f"libv_{name}.so")
    return libs, logs, paths


def inputs(b, dev):
    """The layer's operands at turbo width from a seed on the card."""
    import torch
    from nobs_whisper_torch.ops.quant import quantize_int8
    g = torch.Generator(device=dev).manual_seed(14 + b)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    w = lambda k, n: quantize_int8(rn(k, n) * k ** -0.5)
    x = (rn(b, T, D) * 0.5).to(torch.bfloat16)
    return (x, 1.0 + 0.1 * rn(D), 0.1 * rn(D), w(D, D), 0.1 * rn(D),
            w(D, D), w(D, D), 0.1 * rn(D), w(D, D), 0.1 * rn(D),
            1.0 + 0.1 * rn(D), 0.1 * rn(D), w(D, F), 0.1 * rn(F), w(F, D),
            0.1 * rn(D))


def make_call(lib, kmajor, k12, flags, ins):
    """A call of one version's C entry on ``ins``, its operands and
    workspace made once (the weights as stored, or their K-major copies);
    returns the output."""
    import torch
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import k_major
    x = ins[0]
    b, t, d = x.shape
    dev = x.device
    s8, pv, fuse_o = bool(flags & 1), bool(flags & 2), bool(flags & 4)
    o = ins[8:10] if fuse_o else (None, None)
    ops = ea.fused_qkv_operands(*ins[:8], N_REAL, H, s8, pv, *o)
    if not kmajor:       # the reference's (d_in, d_out) layout
        for i, w in zip((3, 6, 8, 11), (ins[3], ins[5], ins[6], ins[8])):
            if i < 11 or fuse_o:
                ops[i] = w["q"]
    f32 = lambda z: z.float().contiguous().reshape(-1)
    sm = float(D // H) ** -0.5
    if k12:
        mlp = [f32(ins[10]), f32(ins[11]), k_major(ins[12]),
               f32(ins[12]["s"]), f32(ins[13]), k_major(ins[14]),
               f32(ins[14]["s"]), f32(ins[15]),
               *fm.mlp_workspace(b * t, F, BLOCK_F, dev), torch.empty_like(x)]
        every = ops + mlp
        ptrs = [ctypes.c_void_p(z.data_ptr()) for z in every]
        rest = (b, t, d, N_REAL, F, BLOCK_F, ctypes.c_float(sm), flags)
        fn, out = lib.nwt_encoder_layer_fused, every[-1]
    else:
        every = ops
        ptrs = [ctypes.c_void_p(z.data_ptr()) for z in every]
        rest = (b, t, d, N_REAL, ctypes.c_float(sm), flags)
        fn, out = lib.nwt_encoder_attention_fused_qkv, ops[14]

    def call():
        # the stream at each call: a CUDA graph's capture stream too
        st = torch._C._cuda_getCurrentRawStream(dev.index)
        if fn(*ptrs, *rest, ctypes.c_void_p(st)):
            raise RuntimeError("launch failed")
        return out
    call.operands = every   # not only the pointers: alive with the call
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another csrc/ directory")
    ap.add_argument("--tune", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: constants of a variant")
    ap.add_argument("--edit", action="append", default=[],
                    help="LABEL@@OLD@@NEW[@@OLD@@NEW...]: a variant with "
                         "each text OLD of the checkout's sources replaced "
                         "by NEW (an ablation)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as Fn
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.utils.profiling import (cuda_ms,
                                                    device_ms_by_part,
                                                    graph_ms, in_turns)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    src = sources(CSRC)
    versions = {"kernel": src, "q-apart": edited(src, Q_APART, "q-apart"),
                "one-set": edited(src, ONE_SET, "one-set")}
    for spec in args.tune:
        versions[spec.replace(",", "+")] = tuned(src, spec)
    for spec in args.edit:
        label, *pairs = spec.split("@@")
        versions[label] = edited(src, pairs, label)
    if args.baseline:
        versions["baseline"] = sources(args.baseline)
    kmajor = {n for n, files in versions.items()
              if "proj_wgmma.cuh" in files}
    t0 = time.perf_counter()
    libs, logs, paths = build(versions, os.path.join(ROOT, "build",
                                                     "k1_variants"))
    print(f"[build] {len(libs)} versions in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, text in logs.items():
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "'" in line else line
            if (any(k in kernel for k in ("proj_wgmma", "fc2", "qkv_gemm"))
                    and ("Used" in line or "spill" in line
                         or "Performance Loss" in line)):
                print(f"[ptxas] {name}: {kernel[:60]}: {line.strip()}",
                      flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    sm = float(D // H) ** -0.5
    for b in B_ROWS:
        m = b * T
        ins = inputs(b, dev)
        # the yardstick: SDPA and torch._int_mm of the projections on the
        # weights' K-major copies (cuBLAS's faster layout for them)
        qkv = [torch.randn(b, H, T, 64, device=dev, dtype=torch.bfloat16)
               for _ in range(3)]
        mask = torch.zeros(1, T, device=dev, dtype=torch.bool)
        mask[:, :N_REAL] = True
        a8 = torch.randint(-127, 128, (m, D), device=dev, dtype=torch.int8)
        h8 = torch.randint(-127, 128, (m, F), device=dev, dtype=torch.int8)
        km = lambda w: w["q"].t().contiguous().t()
        gemms = {3: [(a8, km(w)) for w in (ins[3], ins[5], ins[6])]}
        gemms[4] = gemms[3] + [(a8, km(ins[8]))]
        gemms[6] = gemms[4] + [(a8, km(ins[12])), (h8, km(ins[14]))]

        def lib_call(n):
            return lambda: (Fn.scaled_dot_product_attention(
                *qkv, attn_mask=mask, scale=sm),
                [torch._int_mm(a, w) for a, w in gemms[n]])
        for key, k12, flags in CASES:
            s8, pv, fuse_o = bool(flags & 1), bool(flags & 2), bool(flags & 4)
            kw = dict(int8_scores=s8, int8_pv=pv)
            if k12:
                ref = fl.encoder_layer_fused_plain(
                    *ins, N_REAL, sm, H, block_f=BLOCK_F, **kw)
            else:
                o = dict(wo=ins[8], bo=ins[9]) if fuse_o else {}
                ref = ea.encoder_attention_fused_qkv_plain(
                    *ins[:8], N_REAL, sm, H, **kw, **o)
            calls, notes, outs = {}, {}, {}
            for name, lib in libs.items():
                call = make_call(lib, name in kmajor, k12, flags, ins)
                first = outs[name] = call().clone()
                torch.cuda.synchronize()
                same = int((first != call()).sum())
                err = (first.float() - ref.float())[:, :N_REAL].abs().max()
                err = err.item()
                ok = err < TOL[key] and bool(torch.isfinite(
                    first.float()).all())
                notes[name] = (f"err {err:.3e} {'ok' if ok else 'FAIL'}, "
                               + ("same bits" if not same else
                                  f"bits differ in {same} elements"))
                if name != "kernel":
                    notes[name] += (", the checkout's bits" if torch.equal(
                        first, outs["kernel"]) else
                        ", not the checkout's bits")
                calls[name] = call
            del ref
            times = in_turns(calls, args.reps)
            alone = {n: graph_ms(calls[n], args.reps) for n in calls}
            split = {}
            for name, call in calls.items():
                try:
                    split[name] = ", ".join(
                        f"{k} {v:.4f}" for k, v in device_ms_by_part(call, 10))
                except Exception as e:
                    split[name] = f"by part not measured: {e!r}"
            n = 6 if k12 else 4 if fuse_o else 3
            lib_ms, lib_alone = cuda_ms(lib_call(n)), graph_ms(lib_call(n))
            int8_ops = 2.0 * m * D * D * (3 + fuse_o) + k12 * 4.0 * m * D * F
            attn = 2.0 * b * H * T * N_REAL * 64
            i8 = int8_ops + attn * (s8 + pv)
            b16 = attn * (2 - s8 - pv)
            nbytes = (2 * m * D * 2 + (3 + fuse_o) * D * D
                      + k12 * 2 * D * F + 8 * D * 4)
            tb = nbytes / PEAK_BYTES
            to = i8 / PEAK_INT8_OPS + b16 / PEAK_BF16_FLOPS
            print(f"[variants] {key} B={b} M={m} d={D} H={H} n_real={N_REAL}"
                  + (f" ffn={F} block_f={BLOCK_F}" if k12 else "") + ": "
                  + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms "
                              f"back to back, {alone[v]:.4f} alone "
                              f"({split[v]}; {notes[v]})" for v in calls)
                  + f"; bound {max(tb, to) * 1e3:.4f} "
                  f"({'bytes' if tb >= to else 'operations'}); SDPA + "
                  f"torch._int_mm x{n} {lib_ms:.4f} back to back, "
                  f"{lib_alone:.4f} alone", flush=True)
            del calls, outs
            torch.cuda.empty_cache()
        del ins, qkv, gemms, a8, h8
        torch.cuda.empty_cache()

    for name, path in paths.items():
        for fn, ops in _build.sass_counts(path).items():
            if not any(k in fn for k in ("proj_wgmma", "fc2", "qkv_gemm")):
                continue
            print(f"[sass] {name} {fn[:70]}: " + ", ".join(
                f"{op} {ops[op]}" for op in SASS_OPS if ops[op])
                + f"; {sum(ops.values())} instructions", flush=True)


if __name__ == "__main__":
    main()
