#!/usr/bin/env python3
"""Launch the decode kernels that set their attributes at their first
launch (K4, K5, K6's decode and prefill kernels, K7) on every visible card
in turn, for the checkout's ``csrc/`` and, with ``--baseline DIR``, for a
whole other copy of it (the parent's, unpacked by ``git archive``), and
print for each (version, card, kernel) whether the launch matched the
kernel's plain version, or the error it raised.

``cudaFuncSetAttribute`` acts on a kernel in the current device's context
only; a kernel that records "done" once per process launches on the next
card without its shared-memory size and its permission for clusters over
8 blocks. Needs two cards or more; from the repo root:

    mkdir -p build/old && git archive HEAD~1 nobs_whisper_torch/csrc | \\
        tar -x -C build/old
    python3 scripts/torch_card_attrs.py \\
        --baseline build/old/nobs_whisper_torch/csrc

Each version builds in a directory of its own under ``build/card_attrs``
beside its copies of the other sources (its quoted includes find them
first), one ``nvcc`` a source, all started together.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("q8_matmul", "cross_attention_decode", "fused_mlp_q8")


def build(name, src_dir, out_root):
    """Build the three sources of one csrc/ copy; {source: library}."""
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import quant as qt
    vdir = os.path.join(out_root, name)
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    for f in os.listdir(src_dir):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), vdir)
    sig = dict(qt._Q8_SIG, **ap._SIG, **fm._K7_SIG)
    texts = {}
    for s in SOURCES:
        with open(os.path.join(vdir, f"{s}.cu")) as f:
            texts[f"{name}_{s}"] = f.read()
    built, _ = _build.build_variants(texts, vdir, sig)
    return {s: built[f"{name}_{s}"] for s in SOURCES}


def checks():
    """{kernel: fn(dev)} raising when the kernel disagrees with its plain
    version (the single-card tests' tolerances)."""
    import numpy as np
    import torch
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import quant as qt
    from nobs_whisper_torch.ops.quant import quantize_int8
    step = dict(rtol=2.0 ** -7, atol=2.0 ** -9)

    def k6(dev, m):
        g = torch.Generator(device=dev).manual_seed(m)
        x = torch.randn(m, 5120, generator=g, device=dev).to(torch.bfloat16)
        w = quantize_int8(torch.randn(5120, 1280, generator=g, device=dev)
                          * 5120 ** -0.5)
        np.testing.assert_allclose(qt.q8_matmul(x, w).cpu().numpy(),
                                   qt.q8_matmul_plain(x, w).cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)

    def k7(dev):
        g = torch.Generator(device=dev).manual_seed(7)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        x = rn(8, 1280).to(torch.bfloat16)
        args = (1.0 + 0.1 * rn(1280), 0.1 * rn(1280),
                quantize_int8(rn(1280, 5120) * 1280 ** -0.5), 0.1 * rn(5120),
                quantize_int8(rn(5120, 1280) * 5120 ** -0.5), 0.1 * rn(1280))
        torch.testing.assert_close(fm.fused_mlp_q8(x, *args).float(),
                                   fm.fused_mlp_q8_plain(x, *args).float(),
                                   **step)

    def cross(dev, q8):
        g = torch.Generator(device=dev).manual_seed(30)
        q = (torch.randn(1, 20, 1, 64, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        k = torch.randn(1, 1, 20, 1500, 64, generator=g, device=dev)
        v = torch.randn(1, 1, 20, 1500, 64, generator=g, device=dev)
        if q8:
            kq, vq = ap.quantize_cross_kv((k, v))
            kq = {z: w[0] for z, w in kq.items()}
            vq = {z: w[0] for z, w in vq.items()}
            got = ap.cross_attention_decode_q8(q, kq, vq)
            ref = ap.cross_attention_decode_q8_plain(q, kq, vq)
        else:
            kT, vv = ap.pack_cross_kv_bf16((k, v))
            packed = {"kT": kT["kT"][0], "v": vv["v"][0]}
            got = ap.cross_attention_decode_bf16(q, packed, 1500)
            ref = ap.cross_attention_decode_bf16_plain(q, packed, 1500)
        torch.testing.assert_close(got.float(), ref.float(), **step)

    return {"K4": lambda d: cross(d, False), "K5": lambda d: cross(d, True),
            "K6-decode (M=8)": lambda d: k6(d, 8),
            "K6-prefill (M=64)": lambda d: k6(d, 64), "K7": k7}


def main():
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--baseline", default=None,
                     help="a whole csrc/ directory to run beside the "
                          "checkout's")
    args = ap_.parse_args()
    import subprocess

    import torch
    from nobs_whisper_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"[card] {smi}", flush=True)
    n = torch.cuda.device_count()
    if n < 2:
        sys.exit(f"needs two cards or more, found {n}")
    out_root = os.path.join(ROOT, "build", "card_attrs")
    versions = [("checkout", _build.CSRC)]
    if args.baseline:
        versions.append(("baseline", os.path.abspath(args.baseline)))
    libs = {name: build(name, d, out_root) for name, d in versions}
    fails = 0
    for name, _ in versions:
        # a version's own libraries, so that its once-only flags start
        # clear on every card
        for s in SOURCES:
            _build._libs[s] = libs[name][s]
        for kernel, fn in checks().items():
            for i in range(n):
                dev = torch.device("cuda", i)
                try:
                    with torch.cuda.device(dev):
                        fn(dev)
                    torch.cuda.synchronize(dev)
                    res = "matches its plain version"
                except Exception as e:     # reported, counted
                    res = f"FAILED: {type(e).__name__}: " + \
                        str(e).splitlines()[0][:160]
                    fails += name == "checkout"
                print(f"[attrs] {name} {kernel} on cuda:{i} (launched "
                      f"{'first' if i == 0 else 'after cuda:0'}): {res}",
                      flush=True)
    for s in SOURCES:
        _build._libs.pop(s, None)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
