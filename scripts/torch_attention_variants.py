#!/usr/bin/env python3
"""Time versions of the port's bf16 attention kernel against each other and
against SDPA, in one process on one NVIDIA card (nobs_whisper_torch's
``csrc/encoder_attention.cu``: K3 and K9).

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
|plain|), max) and SDPA's time on the same q/k/v.

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
B, T, N_REAL = 2, 1536, 1500


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
        for fn in ("nwt_encoder_attention_btd", "nwt_encoder_attention_bhtd"):
            getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 5
                                         + [ctypes.c_float, ctypes.c_void_p])
            getattr(lib, fn).restype = ctypes.c_int
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another encoder_attention.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
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
    libs = build(versions)

    from nobs_whisper_torch.ops import encoder_attention as ea
    dev = torch.device("cuda")
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
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
        order = list(calls) + list(calls)[::-1]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(cuda_ms(calls[name], args.reps))
        mask = torch.zeros(1, T, device=dev, dtype=torch.bool)
        mask[:, :N_REAL] = True
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=mask, scale=sm),
            args.reps)
        print(f"[variants] {key} B={B} T={T} H={h} dh={dh} n_real={N_REAL}: "
              + "; ".join(f"{n} {times[n][0]:.4f}/{times[n][1]:.4f} ms "
                          f"({steps[n]:.3f} steps)" for n in calls)
              + f"; SDPA {sdpa:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
