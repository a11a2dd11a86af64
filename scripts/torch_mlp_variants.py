#!/usr/bin/env python3
"""Time versions of the port's K2 and K8 (the int8 encoder MLP,
nobs_whisper_torch's ``csrc/fused_mlp.cu``) against each other and
against ``torch._int_mm``, in one process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/mlp_variants/`` (gitignored):

* ``kernel``: the checkout's ``fused_mlp.cu``;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source with
  those ``constexpr int`` constants changed (for example
  ``--tune FC2_STAGES=4``);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the
  same source with each text OLD replaced by NEW, for ablations (its bits
  may then differ);
* ``baseline``: another version of the file given with ``--baseline``, for
  example the parent commit's
  (``git show HEAD~1:nobs_whisper_torch/csrc/fused_mlp.cu > build/old.cu``).
  A version that does not include ``gemm_s8_wgmma.cuh`` (the port's first,
  mma.sync K2) takes the weights in the reference's (d_in, d_out) layout;
  the others take their K-major copies, made once before timing.

At each geometry (large-v3-turbo width, d = 1280, ffn = 5120: K2 at a
batch of two windows, M = 3072, block_f 2560, bf16 and f32; K8's block_f
1280 at the knob path's M = 3000 and 1500; at M = 3072 K12's chunk 1280,
640, the whole FFN as one chunk (the two-pass variant) and 256 (the
128-column tiles)), it prints
the card, and for each version its error against the plain version (max
abs, within ``K2_TOL``), whether two calls give the same bits and whether
they are the checkout's, its time back to back (CUDA events over calls of
the raw C entry, in turns: every version in order, then in reverse), alone
on the device (the call captured in a CUDA graph) and each kernel's share
of the device time (``torch.profiler``: ln_quant, fc1, fc2, and the
requant pass where a version has one), beside the bound and
``torch._int_mm`` of the two GEMM shapes on the weights as stored and on
their K-major copies. For the checkout it also prints the port wrapper's
back-to-back time and its host time a call. Last, each version's
registers and spills (``-Xptxas -v``) and the opcode counts of each kernel
(``cuobjdump -sass``: IGMMA is the int8 ``wgmma``, IMMA the int8
``mma.sync``).

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_mlp_variants.py [--baseline build/old.cu]
[--tune NAME=VALUE ...] [--edit LABEL@@OLD@@NEW ...]``. Imports nothing
of JAX.
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

# (key, M, block_f, activation dtype name)
GEOMETRIES = (("K2", 3072, 2560, "bfloat16"), ("K2", 3072, 2560, "float32"),
              ("K8", 3000, 1280, "bfloat16"), ("K8", 3000, 1280, "float32"),
              ("K8", 1500, 1280, "float32"), ("K2", 3072, 1280, "bfloat16"),
              ("K2", 3072, 640, "bfloat16"), ("K2", 3072, 5120, "bfloat16"),
              ("K2", 3072, 256, "bfloat16"))
D, FFN = 1280, 5120
K2_TOL = 5e-2                   # chip_smoke.py's
PEAK_BYTES, PEAK_INT8_OPS = 3.35e12, 1979e12
SASS_OPS = ("IGMMA", "HGMMA", "IMMA", "HMMA", "UTMALDG", "SYNCS", "MUFU",
            "FMUL", "FADD", "I2F", "F2I", "STG", "LDG", "STS", "LDS", "BAR")


def make_call(lib, kmajor, key, args, block_f):
    """A call of one version's C entry on ``args`` (x, ln_g, ln_b, fc1,
    b1, fc2, b2), its output, workspace and operands made once."""
    import torch
    from nobs_whisper_torch.ops import fused_mlp as fm
    x, g, be, fc1, b1, fc2, b2 = args
    m, d = x.shape
    dev = x.device
    f32 = lambda z: z.float().contiguous()
    w1 = fc1["q"].t().contiguous() if kmajor else fc1["q"]
    w2 = fc2["q"].t().contiguous() if kmajor else fc2["q"]
    ops = [x, f32(g), f32(be), w1, f32(fc1["s"]).reshape(FFN), f32(b1), w2,
           f32(fc2["s"]).reshape(d), f32(b2), torch.empty_like(x),
           torch.empty((m, d), dtype=torch.int8, device=dev),
           torch.empty((m,), dtype=torch.float32, device=dev),
           torch.empty((m, FFN), dtype=torch.float32, device=dev),
           torch.empty((m, FFN // block_f), dtype=torch.int32, device=dev),
           torch.empty((m, FFN), dtype=torch.int8, device=dev)]
    fn = getattr(lib, fm._ENTRY[key, x.dtype])
    ptrs = [z.data_ptr() for z in ops]

    def call():
        if fn(*ptrs, m, d, FFN, block_f,
              torch._C._cuda_getCurrentRawStream(dev.index)):
            raise RuntimeError("launch failed")
        return ops[9]
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another fused_mlp.cu")
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
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_int8
    from nobs_whisper_torch.utils.profiling import (cuda_ms,
                                                    device_ms_split,
                                                    graph_ms, in_turns)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    with open(os.path.join(ROOT, "nobs_whisper_torch", "csrc",
                           "fused_mlp.cu")) as f:
        src = f.read()
    versions = {"kernel": src}
    for spec in args.tune:
        text = src
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"\b{name} = \d+", f"{name} = {int(value)}",
                              text)
            if n != 1:
                sys.exit(f"no constant {name} in fused_mlp.cu")
        versions[spec.replace(",", "+")] = text
    for spec in args.edit:
        label, *pairs = spec.split("@@")
        text = src
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                sys.exit(f"{label}: text not found in fused_mlp.cu")
            text = text.replace(old, new)
        versions[label] = text
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
    kmajor = {name for name, text in versions.items()
              if "gemm_s8_wgmma.cuh" in text}
    out_dir = os.path.join(ROOT, "build", "mlp_variants")
    libs, logs = _build.build_variants(versions, out_dir, fm._SIG)
    for name, text in logs.items():
        for line in text.splitlines():
            if ("Used" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    short = lambda n: n.split("(")[0].replace("void nwt::", "").split("<")[0]
    for key, m, block_f, dt in GEOMETRIES:
        xd = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(2 + m + block_f)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        inputs = ((rn(m, D) * 0.5).to(xd), 1.0 + 0.1 * rn(D), 0.1 * rn(D),
                  quantize_int8(rn(D, FFN) * D ** -0.5), 0.1 * rn(FFN),
                  quantize_int8(rn(FFN, D) * FFN ** -0.5), 0.1 * rn(D))
        ref = fm.mlp_int8_plain(*inputs, block_f)
        calls, notes, outs = {}, {}, {}
        for name, lib in libs.items():
            call = make_call(lib, name in kmajor, key, inputs, block_f)
            first = outs[name] = call().clone()
            torch.cuda.synchronize()
            same = bool(torch.equal(first, call()))
            err = (first.float() - ref.float()).abs().max().item()
            ok = err < K2_TOL and bool(torch.isfinite(first.float()).all())
            notes[name] = (f"err {err:.3e} {'ok' if ok else 'FAIL'}, "
                           f"{'same bits' if same else 'bits differ'}")
            if name != "kernel":
                notes[name] += (", the checkout's bits" if torch.equal(
                    first, outs["kernel"]) else ", not the checkout's bits")
            calls[name] = call
        times = in_turns(calls, args.reps)
        alone = {name: graph_ms(calls[name], args.reps) for name in calls}
        split = {}
        for name, call in calls.items():
            _, rest = device_ms_split(call, 10, "\0")
            split[name] = ", ".join(f"{short(k)} {v:.4f}" for k, v in rest)
        a8 = torch.randint(-127, 128, (m, D), device=dev, dtype=torch.int8)
        h8 = torch.randint(-127, 128, (m, FFN), device=dev, dtype=torch.int8)
        w1, w2 = inputs[3]["q"], inputs[5]["q"]
        w1k, w2k = w1.t().contiguous().t(), w2.t().contiguous().t()
        lib_kn = cuda_ms(lambda: (torch._int_mm(a8, w1),
                                  torch._int_mm(h8, w2)), args.reps)
        lib_km = cuda_ms(lambda: (torch._int_mm(a8, w1k),
                                  torch._int_mm(h8, w2k)), args.reps)
        lib_km_alone = graph_ms(lambda: (torch._int_mm(a8, w1k),
                                         torch._int_mm(h8, w2k)), args.reps)
        wrap = fm.encoder_mlp_int8 if key == "K8" else \
            fm.encoder_mlp_int8_resident
        port = lambda: wrap(*inputs, block_f=block_f)
        port_ms = cuda_ms(port, args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            port()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        ops = 2.0 * m * D * FFN * 2
        nbytes = (2 * m * D * inputs[0].element_size() + 2 * D * FFN
                  + (FFN + D) * 4 * 2 + 2 * D * 4)
        tb, to = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
        bn, cluster = fm.fc1_plan(block_f)
        plan = (f"fc1 {bn}-column tiles, clusters of {cluster}" if cluster
                else "the two-pass variant")
        print(f"[variants] {key} M={m} d={D} ffn={FFN} block_f={block_f} "
              f"x {dt} ({plan}): "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms back "
                          f"to back, {alone[v]:.4f} alone ({split[v]}; "
                          f"{notes[v]})" for v in calls)
              + f"; bound {max(tb, to) * 1e3:.4f} "
              f"({'bytes' if tb >= to else 'operations'}); torch._int_mm "
              f"fc1+fc2 {lib_kn:.4f} back to back on the (K, N) weights, "
              f"{lib_km:.4f} on the K-major copies ({lib_km_alone:.4f} "
              f"alone); the port's wrapper {port_ms:.4f} back to back, host "
              f"{host_ms:.4f} ms a call", flush=True)
        del inputs, ref, calls, outs
        torch.cuda.empty_cache()

    for name in libs:
        for fn, ops in _build.sass_counts(os.path.join(
                out_dir, f"lib{name}.so")).items():
            print(f"[sass] {name} {fn}: " + ", ".join(
                f"{op} {ops[op]}" for op in SASS_OPS if ops[op])
                + f"; {sum(ops.values())} instructions", flush=True)


if __name__ == "__main__":
    main()
