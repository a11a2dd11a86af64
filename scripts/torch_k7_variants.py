#!/usr/bin/env python3
"""Time versions of the port's K7 (the decoder's fused int8 MLP,
nobs_whisper_torch's ``csrc/fused_mlp_q8.cu``) against each other and
against LayerNorm + ``torch.matmul`` on bf16-dequantized weights, in one
process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/k7_variants/`` (gitignored):

* ``kernel`` and ``kernel-nopdl``: the checkout's ``fused_mlp_q8.cu``,
  with fc2 by programmatic dependent launch (its default) and by a plain
  stream-ordered launch (``nwt_fused_mlp_q8_set_pdl``);
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source, with
  ``csrc/q8_decode.cuh`` inlined, those ``constexpr int`` constants
  changed (for example ``--tune DSTAGES=4``);
* ``baseline``: another version of the file given with ``--baseline``
  (for example the parent commit's:
  ``git show HEAD~1:nobs_whisper_torch/csrc/fused_mlp_q8.cu >
  build/k7_old.cu``), built with ``csrc/`` on the include path.

For each geometry (large-v3-turbo's decoder MLP, d = 1280, ffn = 5120, at
M = 1 and 8 with bf16 and f32 x, and M = 16 and 24 with bf16 x) it prints
the card, then for each version its error against ``fused_mlp_q8_plain``
(one bf16 step for bf16 x, 1e-3 + 1e-3 relative for f32 x: chip_smoke.py's
bounds), whether two calls give the same bits, its time back to back (CUDA
events over calls of the raw C entry, in turns) and alone on the device
(the calls captured in a CUDA graph over eight weight sets, 105 MB, so
that the weights come from device memory), beside the bound and the
library's time alone. For the checkout at M = 8 it also prints the device
time by kernel (``torch.profiler``: fc1, fc2). Last, ``[test-case]``: each
version at the on-card test's own inputs for M = 16 and 24
(:func:`test_cases`).

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_k7_variants.py [--baseline FILE]
[--tune NAME=VALUE ...]``. Imports nothing of JAX.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

D, FFN, SETS = 1280, 5120, 8
SHAPES = ((1, "bf16"), (8, "bf16"), (1, "f32"), (8, "f32"), (16, "bf16"),
          (24, "bf16"))
BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K6_TOL = dict(rtol=1e-3, atol=1e-3)
PEAK_BYTES, PEAK_BF16_FLOPS = 3.35e12, 989e12


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another fused_mlp_q8.cu")
    ap.add_argument("--tune", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: constants of a variant")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_int8
    from nobs_whisper_torch.utils.profiling import (cuda_ms, device_ms_split,
                                                    graph_ms, in_turns)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    read = lambda name: open(os.path.join(_build.CSRC, name)).read()
    src = read("fused_mlp_q8.cu")
    versions = {"kernel": src}
    inlined = src.replace('#include "q8_decode.cuh"\n',
                          read("q8_decode.cuh").replace("#pragma once\n", ""))
    for spec in args.tune:
        text = inlined
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {int(value)};", text)
            if n != 1:
                sys.exit(f"no constant {name} in fused_mlp_q8.cu or "
                         "q8_decode.cuh")
        versions[spec.replace(",", "+")] = text
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
    out_dir = os.path.join(ROOT, "build", "k7_variants")
    libs, logs = _build.build_variants(versions, out_dir, fm._K7_SIG)
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(60)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ln_g, ln_b = 1.0 + 0.1 * rn(D), 0.1 * rn(D)
    sets = []
    for _ in range(SETS):
        w1, w2 = quantize_int8(rn(D, FFN) * D ** -0.5), quantize_int8(
            rn(FFN, D) * FFN ** -0.5)
        sets.append((w1["q"], w1["s"].reshape(FFN).contiguous(),
                     0.1 * rn(FFN), w2["q"], w2["s"].reshape(D).contiguous(),
                     0.1 * rn(D), w1, w2))
    deq = [(w1["q"].to(torch.bfloat16) * w1["s"].to(torch.bfloat16), b1,
            w2["q"].to(torch.bfloat16) * w2["s"].to(torch.bfloat16), b2)
           for _, _, b1, _, _, b2, w1, w2 in sets]
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    runs = []
    for name, lib in libs.items():
        if hasattr(lib, "nwt_fused_mlp_q8_set_pdl"):
            runs += [(name, lib, 1), (name + "-nopdl", lib, 0)]
        else:
            runs.append((name, lib, None))
    for m, xdt in SHAPES:
        x = rn(m, D).to(dtypes[xdt])
        entry = fm._K7_ENTRY[x.dtype]
        w1q, s1, b1, w2q, s2, b2, w1, w2 = sets[0]
        ref = fm.fused_mlp_q8_plain(x, ln_g, ln_b, w1, b1, w2, b2)
        tol = BF16_STEP if xdt == "bf16" else K6_TOL
        calls, graphs, notes = {}, {}, {}
        for name, lib, pdl in runs:
            acts = [torch.empty(m, FFN, dtype=torch.bfloat16, device=dev)
                    for _ in range(SETS)]
            outs = [torch.empty_like(x) for _ in range(SETS)]

            def call(i=0, lib=lib, pdl=pdl, acts=acts, outs=outs, name=name):
                if pdl is not None:
                    lib.nwt_fused_mlp_q8_set_pdl(pdl)
                a1q, a1s, a1b, a2q, a2s, a2b, _, _ = sets[i]
                if getattr(lib, entry)(
                        ptr(x), ptr(ln_g), ptr(ln_b), ptr(a1q), ptr(a1s),
                        ptr(a1b), ptr(a2q), ptr(a2s), ptr(a2b), ptr(acts[i]),
                        ptr(outs[i]), m, D, FFN, stream()):
                    raise RuntimeError(f"{name}: launch failed")

            call()
            torch.cuda.synchronize()
            first = outs[0].clone()
            call()
            torch.cuda.synchronize()
            same = bool(torch.equal(first, outs[0]))
            diff = (first.float() - ref.float()).abs()
            steps = (diff / (tol["atol"] + tol["rtol"] * ref.float().abs())
                     ).max().item()
            notes[name] = (f"err {diff.max().item():.3e} "
                           f"{'ok' if steps <= 1.0 else 'FAIL'}, "
                           f"{'same bits' if same else 'bits differ'}")
            calls[name] = call
            graphs[name] = (lambda call=call, pdl=pdl, lib=lib:
                            [call(i) for i in range(SETS)])
        times = in_turns(calls, args.reps)
        alone = {}
        for name, lib, pdl in runs:
            if pdl is not None:   # the switch is read when fc2 is launched
                lib.nwt_fused_mlp_q8_set_pdl(pdl)
            alone[name] = graph_ms(graphs[name], args.reps) / SETS
        for name, lib, pdl in runs:
            if pdl is not None:
                lib.nwt_fused_mlp_q8_set_pdl(1)

        def library():
            for w1b, lb1, w2b, lb2 in deq:
                h = F.layer_norm(x.float(), (D,), ln_g, ln_b).to(
                    torch.bfloat16)
                a = F.gelu(torch.matmul(h, w1b).float() + lb1,
                           approximate="tanh").to(torch.bfloat16)
                (x.float() + torch.matmul(a, w2b).float() + lb2).to(x.dtype)

        lib_alone = graph_ms(library, args.reps) / SETS
        nbytes = (2 * D * FFN + 2 * (FFN + D) * 4 + 2 * D * 4
                  + 2 * m * D * x.element_size())
        tb, to = nbytes / PEAK_BYTES, 4.0 * m * D * FFN / PEAK_BF16_FLOPS
        print(f"[variants] K7 M={m} d={D} ffn={FFN} x {xdt}: "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms back "
                          f"to back, {alone[v]:.4f} alone ({notes[v]})"
                          for v in calls)
              + f"; bound {max(tb, to) * 1e3:.4f} "
              f"({'bytes' if tb >= to else 'operations'}); LN + matmuls on "
              f"bf16-dequantized weights {lib_alone:.4f} alone", flush=True)
        if m == 8 and xdt == "bf16":
            fn = calls["kernel"]
            for _ in range(3):
                fn()
            _, rows = device_ms_split(fn, args.reps, "\0")
            print("[variants] K7 M=8 bf16 x, the checkout by kernel (one "
                  "weight set): "
                  + "; ".join(f"{n.split('(')[0][:120]} {t:.4f} ms"
                              for n, t in rows), flush=True)
        torch.cuda.synchronize()
    test_cases(libs, fm, quantize_int8, ptr, stream, dev)


def test_cases(libs, fm, quantize_int8, ptr, stream, dev):
    """Each version at ``tests/test_torch_kernels_gpu.py::
    test_k7_kernel_matches_plain``'s inputs for its largest row counts
    (the same seed and draws): the elements outside the test's tolerance
    against ``fused_mlp_q8_plain``, and the rows they lie in; beside them,
    the elements of the plain version's bf16(LN(x)) that differ from
    bf16 of the LayerNorm taken in f64 (an f32 summation order's flips)."""
    import torch
    from nobs_whisper_torch.ops.quant import ln_f32
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for m, xdt in ((16, "f32"), (24, "f32"), (24, "bf16")):
        g = torch.Generator(device=dev).manual_seed(m + D)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        x = rn(m, D).to(dtypes[xdt])
        ln_g, ln_b = 1.0 + 0.1 * rn(D), 0.1 * rn(D)
        w1, w2 = quantize_int8(rn(D, FFN) * D ** -0.5), quantize_int8(
            rn(FFN, D) * FFN ** -0.5)
        b1, b2 = 0.1 * rn(FFN), 0.1 * rn(D)
        ref = fm.fused_mlp_q8_plain(x, ln_g, ln_b, w1, b1, w2, b2).float()
        tol = BF16_STEP if xdt == "bf16" else K6_TOL
        h = ln_f32(x, ln_g, ln_b).to(torch.bfloat16)
        xd = x.double()
        mu = xd.mean(-1, keepdim=True)
        h64 = ((xd - mu) / torch.sqrt(((xd - mu) ** 2).mean(-1, keepdim=True)
                                      + 1e-5) * ln_g.double()
               + ln_b.double()).to(torch.bfloat16)
        notes = []
        for name, lib in libs.items():
            act = torch.empty(m, FFN, dtype=torch.bfloat16, device=dev)
            out = torch.empty_like(x)
            s1, s2 = (w1["s"].reshape(FFN).contiguous(),
                      w2["s"].reshape(D).contiguous())
            if getattr(lib, fm._K7_ENTRY[x.dtype])(
                    ptr(x), ptr(ln_g), ptr(ln_b), ptr(w1["q"]), ptr(s1),
                    ptr(b1), ptr(w2["q"]), ptr(s2), ptr(b2), ptr(act),
                    ptr(out), m, D, FFN, stream()):
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            bad = diff > tol["atol"] + tol["rtol"] * ref.abs()
            rows = sorted(set(bad.nonzero()[:, 0].tolist()))
            notes.append(f"{name} {int(bad.sum())} of {bad.numel()} outside "
                         f"(max abs err {diff.max().item():.3e}, rows "
                         f"{rows})")
        flips = (h != h64).nonzero()[:, 0].tolist()
        print(f"[test-case] K7 M={m} x {xdt}, seed {m + D}: "
              + "; ".join(notes) + f"; plain bf16(LN(x)) vs f64 LN: "
              f"{len(flips)} flips, rows {sorted(set(flips))}", flush=True)


if __name__ == "__main__":
    main()
