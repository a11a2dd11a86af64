#!/usr/bin/env python3
"""Time versions of the port's K13 (the fused conv stem,
nobs_whisper_torch's ``csrc/conv_stem.cu``) against each other and
against two bf16 ``F.conv1d``, in one process on one NVIDIA card.

Versions, each built from source with the port's ``nvcc`` flags into
``build/stem_variants/`` (gitignored):

* ``kernel``: the checkout's ``conv_stem.cu``;
* ``NAME=VALUE[,NAME=VALUE]`` given with ``--tune``: the same source with
  those ``constexpr int`` constants changed (for example
  ``--tune STEM_STAGES=3``);
* ``LABEL`` given with ``--edit LABEL@@OLD@@NEW[@@OLD@@NEW...]``: the
  same source with each text OLD replaced by NEW, for ablations (for
  example the gelu taken out of the epilogue, to see what it costs; its
  error check then fails);
* ``baseline``: another version of the file given with ``--baseline``, for
  example the parent commit's
  (``git show HEAD~1:nobs_whisper_torch/csrc/conv_stem.cu > build/old.cu``).
  A baseline whose C entry takes the weights repacked n-major (the port's
  first K13, ``w1t``/``w2t``) gets them repacked, the mel transposed and
  padded and the biases converted to f32 at every call, as its wrapper
  did, and that work is part of its time.

For each geometry of ``chip_smoke.py``'s K13 lines (B = 2 windows of 3000
frames at d = 1280: C_in = 128 at t_out_pad 1536 and 1504, C_in = 80; and
B = 8, the serving batcher's ``max_batch``), on bf16 weights, biases and
positions as the serving engine holds them, it prints the card, and for
each version its error against ``encoder_stem_fused_plain`` (max abs,
within ``STEM_TOL``, padded rows zero), whether two calls give the same
bits, its time back to back (CUDA events over calls of the raw C entry, in
turns: every version in order, then in reverse order), alone on the device
(the call captured in a CUDA graph and replayed) and each kernel's share
of the device time (``torch.profiler``), beside the bound and the two
``F.conv1d`` of the unfused stem, back to back and alone. For the checkout
it also prints the port wrapper's (``ops/conv_stem.py::
encoder_stem_fused``) host time per call (host clock over calls that
enqueue without waiting) and its back-to-back time. Last, each version's
registers and spills (``-Xptxas -v``) and the opcode counts of each kernel
in its library (``cuobjdump -sass``: HGMMA is ``wgmma``, HMMA
``mma.sync``).

Run from the repo root on a machine with a card and ``nvcc``:
``python3 scripts/torch_stem_variants.py [--baseline build/old.cu]
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

# (B, C_in, t_out_pad) at 3000 frames, d = 1280
GEOMETRIES = ((2, 128, 1536), (2, 128, 1504), (2, 80, 1536), (8, 128, 1536))
N_FRAMES, D = 3000, 1280
STEM_TOL = 3e-2                 # chip_smoke.py's
PEAK_BYTES, PEAK_BF16_FLOPS = 3.35e12, 989e12
_P, _I = ctypes.c_void_p, ctypes.c_int
SIG_NEW = [_P] * 5 + [_I] + [_P] * 4 + [_I] * 5 + [_P]
SIG_OLD = [_P] * 8 + [_I] * 5 + [_P]
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "MUFU", "FMUL", "FADD",
            "F2FP", "STG", "LDG", "STS", "LDS", "BAR")


def make_call(lib, repacked, args, t_pad):
    """A call of one version's C entry on ``args`` (mel f32, bf16 w1, b1,
    w2, b2, pos), its output and workspace allocated once."""
    import torch
    import torch.nn.functional as F
    mel, w1, b1, w2, b2, pos = args
    b, c_in, n = mel.shape
    dev, bf = mel.device, torch.bfloat16
    out = torch.empty((b, t_pad, D), dtype=bf, device=dev)
    a = torch.empty((b, n, D), dtype=bf, device=dev)
    stream = lambda: torch._C._cuda_getCurrentRawStream(dev.index)
    posb = pos[:n // 2].contiguous()
    if not repacked:
        cp = -(-c_in // 8) * 8
        x = torch.empty((b, n, cp), dtype=bf, device=dev)

        def call():
            if lib.nwt_encoder_stem(
                    mel.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), 0, posb.data_ptr(),
                    x.data_ptr(), a.data_ptr(), out.data_ptr(), b, n, c_in,
                    D, t_pad, stream()):
                raise RuntimeError("launch failed")
            return out
        return call

    def call():   # the parent wrapper's per-call work, then its entry
        c = -(-c_in // 32) * 32
        x = F.pad(mel.transpose(1, 2).to(bf), (0, c - c_in)).contiguous()
        w1t = F.pad(w1, (0, 0, 0, c - c_in)).permute(2, 0, 1).reshape(
            D, 3 * c).contiguous()
        w2t = w2.permute(2, 0, 1).reshape(D, 3 * D).contiguous()
        b1f, b2f = b1.float(), b2.float()
        if lib.nwt_encoder_stem(
                x.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), w2t.data_ptr(),
                b2f.data_ptr(), posb.data_ptr(), a.data_ptr(),
                out.data_ptr(), b, n, c, D, t_pad, stream()):
            raise RuntimeError("launch failed")
        return out
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another conv_stem.cu")
    ap.add_argument("--tune", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: constants of a variant")
    ap.add_argument("--edit", action="append", default=[],
                    help="LABEL@@OLD@@NEW[@@OLD@@NEW...]: a variant with "
                         "each text OLD of the checkout's source replaced "
                         "by NEW (an ablation; its error check may fail)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.ops import conv_stem as cs
    from nobs_whisper_torch.utils.profiling import (cuda_ms,
                                                    device_ms_split,
                                                    graph_ms, in_turns)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    with open(os.path.join(ROOT, "nobs_whisper_torch", "csrc",
                           "conv_stem.cu")) as f:
        src = f.read()
    versions = {"kernel": src}
    for spec in args.tune:
        text = src
        for item in spec.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+",
                              f"constexpr int {name} = {int(value)}", text)
            if n != 1:
                sys.exit(f"no constant {name} in conv_stem.cu")
        versions[spec.replace(",", "+")] = text
    for spec in args.edit:
        label, *pairs = spec.split("@@")
        text = src
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                sys.exit(f"{label}: text not found in conv_stem.cu")
            text = text.replace(old, new)
        versions[label] = text
    if args.baseline:
        with open(args.baseline) as f:
            versions["baseline"] = f.read()
    repacked = {name for name, text in versions.items() if "w1t" in text}
    out_dir = os.path.join(ROOT, "build", "stem_variants")
    libs, logs = _build.build_variants(versions, out_dir, {})
    for name, lib in libs.items():   # the two C entries' arguments differ
        lib.nwt_encoder_stem.argtypes = (SIG_OLD if name in repacked
                                         else SIG_NEW)
        lib.nwt_encoder_stem.restype = ctypes.c_int
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    for b, c_in, t_pad in GEOMETRIES:
        g = torch.Generator(device=dev).manual_seed(13 + b + c_in + t_pad)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        bf = torch.bfloat16
        inputs = (rn(b, c_in, N_FRAMES) * 0.5,
                  (rn(3, c_in, D) * (3 * c_in) ** -0.5).to(bf),
                  (0.1 * rn(D)).to(bf),
                  (rn(3, D, D) * (3 * D) ** -0.5).to(bf),
                  (0.1 * rn(D)).to(bf),
                  (0.1 * rn(N_FRAMES // 2, D)).to(bf))
        ref = cs.encoder_stem_fused_plain(*inputs, t_pad)
        t_half = N_FRAMES // 2
        calls, notes, outs = {}, {}, {}
        for name, lib in libs.items():
            call = make_call(lib, name in repacked, inputs, t_pad)
            first = outs[name] = call().clone()
            torch.cuda.synchronize()
            same = bool(torch.equal(first, call()))
            err = (first.float() - ref.float()).abs().max().item()
            zeros = not bool(first[:, t_half:].any())
            ok = err < STEM_TOL and zeros
            notes[name] = (f"err {err:.3e} {'ok' if ok else 'FAIL'}, "
                           f"{'same bits' if same else 'bits differ'}")
            if name != "kernel":
                notes[name] += (", the checkout's bits" if torch.equal(
                    first, outs["kernel"]) else ", not the checkout's bits")
            calls[name] = call
        times = in_turns(calls, args.reps)
        alone = {name: graph_ms(calls[name], args.reps) for name in calls}
        split = {}   # each kernel's device ms a call, by name
        for name, call in calls.items():
            _, rest = device_ms_split(call, 10, "\0")
            split[name] = ", ".join(
                f"{k.split('(')[0].replace('void nwt::', '')} {v:.4f}"
                for k, v in rest)
        xb = inputs[0].to(bf)
        k1 = inputs[1].permute(2, 1, 0).contiguous()
        k2 = inputs[3].permute(2, 1, 0).contiguous()
        a = torch.randn(b, D, N_FRAMES, device=dev, dtype=bf)
        convs = lambda: (F.conv1d(xb, k1, inputs[2], padding=1),
                         F.conv1d(a, k2, inputs[4], stride=2, padding=1))
        lib_ms = cuda_ms(convs, args.reps)
        lib_alone = graph_ms(convs, args.reps)
        port = lambda: cs.encoder_stem_fused(*inputs, t_pad)
        port_ms = cuda_ms(port, args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            port()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        flops = (2.0 * b * N_FRAMES * 3 * c_in * D
                 + 2.0 * b * t_half * 3 * D * D)
        nbytes = (b * c_in * N_FRAMES * 4 + (3 * c_in * D + 3 * D * D
                  + t_half * D + 2 * D) * 2 + b * t_pad * D * 2)
        tb, to = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
        print(f"[variants] K13 B={b} C_in={c_in} frames={N_FRAMES} d={D} "
              f"t_out_pad={t_pad}: "
              + "; ".join(f"{v} {times[v][0]:.4f}/{times[v][1]:.4f} ms back "
                          f"to back, {alone[v]:.4f} alone ({split[v]}; "
                          f"{notes[v]})" for v in calls)
              + f"; bound {max(tb, to) * 1e3:.4f} "
              f"({'bytes' if tb >= to else 'operations'}); F.conv1d x2 "
              f"(bf16) {lib_ms:.4f} back to back, {lib_alone:.4f} alone; "
              f"the port's wrapper {port_ms:.4f} back to back, host "
              f"{host_ms:.4f} ms a call", flush=True)
        del inputs, ref, calls, a
        torch.cuda.empty_cache()

    # what a call costs the host, by part (us a call, 2000 calls each; a
    # tiny shape, so that the card keeps up and never paces the host)
    inputs = (torch.randn(1, 80, 64, device=dev),
              *(torch.randn(*s, device=dev).to(torch.bfloat16) for s in (
                  (3, 80, 128), (128,), (3, 128, 128), (128,), (32, 128))))
    lib = libs["kernel"]
    x = torch.empty((1, 64, 80), dtype=torch.bfloat16, device=dev)
    a = torch.empty((1, 64, 128), dtype=torch.bfloat16, device=dev)
    out = torch.empty((1, 32, 128), dtype=torch.bfloat16, device=dev)
    cargs = [z.data_ptr() for z in inputs[:5]] + [0, inputs[5].data_ptr(),
                                                   x.data_ptr(), a.data_ptr(),
                                                   out.data_ptr(), 1, 64, 80,
                                                   128, 32]
    raw_stream = torch._C._cuda_getCurrentRawStream(dev.index)
    parts = {
        "torch.empty((2, 1536, 1280))":
            lambda: torch.empty((2, 1536, 1280), dtype=torch.bfloat16,
                                device=dev),
        "the entry point from _build.load":
            lambda: _build.load("conv_stem", cs._SIG).nwt_encoder_stem,
        "the C entry (3 launches, 4 tensor maps), arguments ready":
            lambda: lib.nwt_encoder_stem(*cargs, raw_stream),
        "the port's wrapper": lambda: cs.encoder_stem_fused(*inputs, 32)}
    for what, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"[host] {what}: {us:.2f} us a call", flush=True)

    for name in libs:
        for fn, ops in _build.sass_counts(os.path.join(
                out_dir, f"lib{name}.so")).items():
            print(f"[sass] {name} {fn}: " + ", ".join(
                f"{op} {ops[op]}" for op in SASS_OPS if ops[op])
                + f"; {sum(ops.values())} instructions", flush=True)


if __name__ == "__main__":
    main()
