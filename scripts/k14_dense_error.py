#!/usr/bin/env python3
"""How far K14 and the port's dense f32 log-mels are from the exact one.

For B 30 s windows of ``utils/testing.py::tone_burst_windows`` (the PCM of
the on-card test ``test_k14_kernel_matches_plain``) at each seed, prints the
largest error against ``log_mel_numpy_f64`` (the float64 oracle; its raw
log10 is 4 n - 4 above the clamp) of:

* ``plain``: K14's plain version, ``log10_mel_pallas_plain`` (the TPU
  kernel's dense DFT matmuls in f32, TF32 off);
* ``lms``: the port's ``log_mel_spectrogram`` (a dense f32 DFT; normalized
  only);
* ``kernel``: K14, ``log10_mel_pallas`` (on a card only);

on the raw log10 above each window's max - 8 (where the checks hold it,
bound 4e-4) and normalized (bound 1e-4), with the window, frame and band
of the plain version's worst raw value and its level under the window's
max; on a card also |kernel - plain| on both scales.

From the repo root: ``python3 scripts/k14_dense_error.py [--device cuda]
[--b 40] [--mels 128] [--seeds 168 1 2 3]`` (the CPU by default; on the
CPU the windows go one at a time). Imports nothing of JAX.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch
    from nobs_whisper_torch.audio.mel import (log_mel_numpy_f64,
                                              log_mel_spectrogram)
    from nobs_whisper_torch.ops import mel_pallas as mp
    from nobs_whisper_torch.utils.testing import tone_burst_windows

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--b", type=int, default=40)
    ap.add_argument("--mels", type=int, default=128)
    ap.add_argument("--seeds", type=int, nargs="+", default=[168, 1, 2, 3])
    args = ap.parse_args()
    dev = torch.device(args.device)
    chunk = args.b if dev.type == "cuda" else 1
    norm = lambda z: ((torch.maximum(z, torch.amax(z, dim=(1, 2),
                                                   keepdim=True) - 8.0)
                       + 4.0) / 4.0).transpose(1, 2)
    for seed in args.seeds:
        pcm = tone_burst_windows(args.b, seed)
        worst = {}

        def note(key, err, where=None):
            if err > worst.get(key, (-1.0,))[0]:
                worst[key] = (err, where)

        for s in range(0, args.b, chunk):
            a = pcm[s:s + chunk]
            audio = torch.from_numpy(a).to(dev)
            o = torch.from_numpy(np.stack([log_mel_numpy_f64(w, args.mels)
                                           for w in a])).to(dev)
            raw64 = 4.0 * o.transpose(1, 2) - 4.0
            plain = mp.log10_mel_pallas_plain(audio, args.mels)
            mx = torch.amax(plain, dim=(1, 2), keepdim=True)
            keep = plain > mx - 8.0
            d = ((plain - raw64).abs() * keep).flatten()
            i = int(d.argmax())
            w, f, m = np.unravel_index(i, plain.shape)
            note("plain raw", d[i].item(),
                 f"window {s + w}, frame {f}, band {m}, "
                 f"{(plain[w, f, m] - mx[w, 0, 0]).item():.4f} under max")
            note("plain norm", (norm(plain) - o).abs().max().item())
            lms = log_mel_spectrogram(audio, args.mels)
            note("lms norm", (lms - o).abs().max().item())
            if dev.type == "cuda":
                got = mp.log10_mel_pallas(audio, args.mels)
                note("kernel raw", (got - raw64).abs()[keep].max().item())
                note("kernel norm", (norm(got) - o).abs().max().item())
                note("|kernel - plain| raw",
                     (got - plain).abs()[keep].max().item())
                note("|kernel - plain| norm",
                     (norm(got) - norm(plain)).abs().max().item())
        print(f"[k14] {args.device} B={args.b} n_mels={args.mels} seed={seed}"
              ": " + "; ".join(f"{k} {v[0]:.4e}" + (f" ({v[1]})" if v[1]
                                                     else "")
                               for k, v in worst.items()), flush=True)


if __name__ == "__main__":
    main()
