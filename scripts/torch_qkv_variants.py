#!/usr/bin/env python3
"""Time versions of the port's K10 and K11 (the int8 encoder's attention
projections under ``NWT_INT8_QKV``, nobs_whisper_torch's
``csrc/fused_qkv.cu``) against each other and against ``torch._int_mm``,
in one process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/qkv_variants/`` (gitignored):

* ``kernel``: the checkout's ``fused_qkv.cu``, with ``proj_wgmma.cuh``
  (its kernel and constants) inlined;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source with
  those ``constexpr int`` constants changed (for example
  ``--tune K11_BN=128``);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the
  same source with each text OLD replaced by NEW, for ablations (its bits
  may then differ);
* ``baseline``: another version of the file given with ``--baseline``,
  built against the ``.cuh`` headers that lie beside it, where there are
  any (else the checkout's). For the parent commit's kernels:
  ``mkdir -p build/old && git archive HEAD~1 nobs_whisper_torch/csrc |
  tar -x -C build/old``, then ``--baseline
  build/old/nobs_whisper_torch/csrc/fused_qkv.cu``. A version that does
  not include ``gemm_s8_wgmma.cuh`` (the port's first, mma.sync K10/K11)
  takes the weights in the reference's (d_in, d_out) layout; the others
  take their K-major copies, made once before timing.

At each geometry (large-v3-turbo width, d = 1280: K10 and K11 at the knob
path's rows, M = 3000 for a batch of two windows and 1500 for one, bf16
and f32 activations) it prints the card, and for each version its error
against the plain version (max abs, within ``QKV_TOL``), whether two calls
give the same bits and whether they are the checkout's, its time back to
back (CUDA events over calls of the raw C entry, in turns: every version
in order, then in reverse), alone on the device (the call captured in a
CUDA graph) and each kernel's share of the device time
(``torch.profiler``: the quantization pass against the GEMM), beside the
bound and ``torch._int_mm`` of the same int8 GEMM shapes on the weights as
stored and on their K-major copies. For the checkout it also prints the
port wrapper's back-to-back time and its host time a call. Last, each
version's registers and spills (``-Xptxas -v``) and the opcode counts of
each kernel (``cuobjdump -sass``: IGMMA is the int8 ``wgmma``, IMMA the
int8 ``mma.sync``).

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_qkv_variants.py [--baseline FILE]
[--tune NAME=VALUE ...] [--edit LABEL@@OLD@@NEW ...]``. Imports nothing
of JAX.
"""

import argparse
import concurrent.futures
import glob
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (key, M, activation dtype name)
GEOMETRIES = tuple((key, m, dt) for key in ("K11", "K10")
                   for m in (3000, 1500) for dt in ("bfloat16", "float32"))
D = 1280
QKV_TOL = 5e-2                  # chip_smoke.py's
PEAK_BYTES, PEAK_INT8_OPS = 3.35e12, 1979e12
SASS_OPS = ("IGMMA", "HGMMA", "IMMA", "HMMA", "UTMALDG", "UTMASTG", "SYNCS",
            "MUFU", "FMUL", "FADD", "I2F", "F2I", "STG", "LDG", "STS", "LDS",
            "BAR")


def inputs(key, m, xd, dev):
    """(x, ln_g, ln_b, wq, bq, wk, wv, bv) for K10, (x, a, wo, bo) for
    K11, from a seed on the card."""
    import torch
    from nobs_whisper_torch.ops.quant import quantize_int8
    g = torch.Generator(device=dev).manual_seed(12 + m)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    mkw = lambda: quantize_int8(rn(D, D) * D ** -0.5)
    x = (rn(m, D) * 0.5).to(xd)
    if key == "K11":
        return x, (rn(m, D) * 0.5).to(xd), mkw(), 0.1 * rn(D)
    wq, wk, wv = mkw(), mkw(), mkw()
    return (x, 1.0 + 0.1 * rn(D), 0.1 * rn(D), wq, 0.1 * rn(D), wk, wv,
            0.1 * rn(D))


def make_call(lib, kmajor, key, args):
    """A call of one version's C entry of ``key`` on ``args``, its
    outputs, workspace and operands made once; returns its outputs."""
    import torch
    from nobs_whisper_torch.ops import fused_qkv as fq
    x = args[0]
    m, d = x.shape
    dev = x.device
    f32 = lambda z: z.float().contiguous().reshape(-1)
    w = lambda qt: qt["q"].t().contiguous() if kmajor else qt["q"]
    xq, sx = fq.qkv_workspace(m, d, dev)
    if key == "K11":
        _, a, wo, bo = args
        ops = [x, a, w(wo), f32(wo["s"]), f32(bo), torch.empty_like(x), xq,
               sx]
    else:
        _, g, be, wq, bq, wk, wv, bv = args
        ops = [x, f32(g), f32(be), w(wq), f32(wq["s"]), f32(bq), w(wk),
               f32(wk["s"]), w(wv), f32(wv["s"]), f32(bv),
               *(torch.empty_like(x) for _ in range(3)), xq, sx]
    fn = getattr(lib, fq._ENTRY[key, x.dtype])
    ptrs = [z.data_ptr() for z in ops]

    def call():
        # ops, not only the pointers: its copies and the workspace live as
        # long as the call
        if fn(*ptrs, m, d, torch._C._cuda_getCurrentRawStream(dev.index)):
            raise RuntimeError("launch failed")
        return ops[-5:-2] if key == "K10" else ops[5:6]
    return call


def build(versions, baseline_dir, out_dir):
    """Build every version; the baseline in a directory of its own beside
    copies of the headers next to its file, which its quoted includes
    then find before the checkout's."""
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import fused_qkv as fq
    jobs = {name: ({name: text}, out_dir) for name, text in versions.items()
            if name != "baseline"}
    if "baseline" in versions:
        bdir = os.path.join(out_dir, "baseline")
        os.makedirs(bdir, exist_ok=True)
        for h in glob.glob(os.path.join(baseline_dir, "*.cuh")):
            shutil.copy(h, bdir)
        jobs["baseline"] = ({"baseline": versions["baseline"]}, bdir)
    libs, logs, paths = {}, {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(_build.build_variants, src, d, fq._SIG)
                for name, (src, d) in jobs.items()}
        for name, fut in futs.items():
            lib, log = fut.result()
            libs[name], logs[name] = lib[name], log[name]
            paths[name] = os.path.join(jobs[name][1], f"lib{name}.so")
    return libs, logs, paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another fused_qkv.cu")
    ap.add_argument("--tune", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: constants of a variant")
    ap.add_argument("--edit", action="append", default=[],
                    help="LABEL@@OLD@@NEW[@@OLD@@NEW...]: a variant with "
                         "each text OLD of the checkout's source replaced "
                         "by NEW (an ablation)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import fused_qkv as fq
    from nobs_whisper_torch.utils.profiling import (cuda_ms,
                                                    device_ms_split,
                                                    graph_ms, in_turns)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    csrc = os.path.join(ROOT, "nobs_whisper_torch", "csrc")
    with open(os.path.join(csrc, "fused_qkv.cu")) as f:
        src = f.read()
    # the kernel and its constants live in proj_wgmma.cuh: inlined, so
    # that --tune and --edit reach them
    with open(os.path.join(csrc, "proj_wgmma.cuh")) as f:
        header = f.read().replace("#pragma once\n", "")
    src = src.replace('#include "proj_wgmma.cuh"\n', header)
    versions = {"kernel": src}
    for spec in args.tune:
        text = src
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"\b{name} = \d+", f"{name} = {int(value)}",
                              text)
            if n != 1:
                sys.exit(f"no constant {name} in fused_qkv.cu")
        versions[spec.replace(",", "+")] = text
    for spec in args.edit:
        label, *pairs = spec.split("@@")
        text = src
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                sys.exit(f"{label}: text not found in fused_qkv.cu")
            text = text.replace(old, new)
        versions[label] = text
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
    kmajor = {name for name, text in versions.items()
              if "gemm_s8_wgmma.cuh" in text}
    out_dir = os.path.join(ROOT, "build", "qkv_variants")
    t0 = time.perf_counter()
    libs, logs, paths = build(
        versions, os.path.dirname(os.path.abspath(args.baseline or ".")),
        out_dir)
    print(f"[build] {len(libs)} versions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if ("Used" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    short = lambda n: n.split("(")[0].replace("void nwt::", "").split("<")[0]
    for key, m, dt in GEOMETRIES:
        xd = getattr(torch, dt)
        ins = inputs(key, m, xd, dev)
        if key == "K11":
            plain = lambda: [fq.residual_o_int8_plain(*ins)]
            port = lambda: fq.residual_o_int8(*ins)
            pairs = [ins[2]["q"]]
        else:
            plain = lambda: list(fq.encoder_qkv_int8_plain(*ins))
            port = lambda: fq.encoder_qkv_int8(*ins)
            pairs = [ins[3]["q"], ins[5]["q"], ins[6]["q"]]
        ref = plain()
        calls, notes, outs = {}, {}, {}
        for name, lib in libs.items():
            call = make_call(lib, name in kmajor, key, ins)
            first = outs[name] = [z.clone() for z in call()]
            torch.cuda.synchronize()
            same = [int((a != b).sum()) for a, b in zip(first, call())]
            err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(first, ref))
            ok = err < QKV_TOL and all(bool(torch.isfinite(a.float()).all())
                                       for a in first)
            notes[name] = (f"err {err:.3e} {'ok' if ok else 'FAIL'}, " + (
                "same bits" if not any(same) else
                f"bits differ in {'/'.join(map(str, same))} elements"))
            if name != "kernel":
                notes[name] += (", the checkout's bits" if all(
                    torch.equal(a, b) for a, b in zip(first, outs["kernel"]))
                    else ", not the checkout's bits")
            calls[name] = call
        times = in_turns(calls, args.reps)
        alone = {name: graph_ms(calls[name], args.reps) for name in calls}
        split = {}
        for name, call in calls.items():
            _, rest = device_ms_split(call, 10, "\0")
            split[name] = ", ".join(f"{short(k)} {v:.4f}" for k, v in rest)
        a8 = torch.randint(-127, 128, (m, D), device=dev, dtype=torch.int8)
        kn = lambda: [torch._int_mm(a8, w) for w in pairs]
        kms = [w.t().contiguous().t() for w in pairs]
        km = lambda: [torch._int_mm(a8, w) for w in kms]
        lib_kn, lib_km = cuda_ms(kn, args.reps), cuda_ms(km, args.reps)
        lib_km_alone = graph_ms(km, args.reps)
        port_ms = cuda_ms(port, args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            port()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        n = len(pairs)
        ops = 2.0 * m * D * D * n
        eb = ins[0].element_size()
        nbytes = ((4 * m * D * eb + 3 * D * D + 8 * D * 4) if key == "K10"
                  else (3 * m * D * eb + D * D + 2 * D * 4))
        tb, to = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
        print(f"[variants] {key} M={m} d={D} x {dt}: "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms back "
                          f"to back, {alone[v]:.4f} alone ({split[v]}; "
                          f"{notes[v]})" for v in calls)
              + f"; bound {max(tb, to) * 1e3:.4f} "
              f"({'bytes' if tb >= to else 'operations'}); torch._int_mm "
              f"x{n} {lib_kn:.4f} back to back on the (K, N) weights, "
              f"{lib_km:.4f} on the K-major copies ({lib_km_alone:.4f} "
              f"alone); the port's wrapper {port_ms:.4f} back to back, host "
              f"{host_ms:.4f} ms a call", flush=True)
        del ins, ref, calls, outs
        torch.cuda.empty_cache()

    for name, path in paths.items():
        for fn, ops in _build.sass_counts(path).items():
            print(f"[sass] {name} {fn}: " + ", ".join(
                f"{op} {ops[op]}" for op in SASS_OPS if ops[op])
                + f"; {sum(ops.values())} instructions", flush=True)


if __name__ == "__main__":
    main()
