"""Seed sweep of the port's unquantized bf16 encoder and window program
against the JAX package on the CPU (not a test; pytest does not collect
it). For each tiny configuration (d=128 with 2 heads: K3; d=192 with 3
heads: K9) and each weight seed it prints one line:

* the two-layer encoder states of the port against the reference run op
  by op (``jax.disable_jit`` with its kernels in interpret mode), on the
  weights of ``test_torch_model._float_bf16_case`` (random biases and
  LayerNorm gains): largest absolute difference, share of elements that
  differ, share more than one bf16 step apart;
* the same for the port against itself with one conv1 output element
  moved by one bf16 step: how far a single rounding difference spreads;
* for the window program of ``test_torch_slice._window_slice``: which
  windows give equal greedy tokens, port against reference and port
  against the nudged port.

With ``decode`` it prints instead, for the int8 window program with the
decode kernels' knobs on (``test_torch_decode_kernels``: int8 cross-KV
with K5 and K6, or the packed layout with K4 and K6, the reference's
kernels routed to interpret mode) and each weight seed, which windows give
equal greedy tokens.

Run from the repo root: ``PYTHONPATH=. python tests/torch_bf16_seed_sweep.py
[n_seeds] [decode]`` (10 seeds take ~6 min on one CPU core, ~8 min with
``decode``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nobs_whisper_tpu.models import whisper as jw  # noqa: E402
from nobs_whisper_torch.models import whisper as tw  # noqa: E402

import test_torch_model as tm  # noqa: E402
import test_torch_slice as ts  # noqa: E402


def bf16_step(x):
    """One bf16 step (8 significant bits) at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -40))) - 7)


def compare(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    d = np.abs(ref - got)
    return (f"max {d.max():.4g} differ {np.mean(d > 0):.4f} "
            f">1 step {np.mean(d > bf16_step(ref) * 1.0001):.4f}")


class Nudge:
    """Within the block, the port's conv1 output has element (0, 5, 7)
    moved up by one bf16 step."""

    def __enter__(self):
        self.real = real = tw._conv1d

        def nudged(x, w, b, stride):
            y = real(x, w, b, stride)
            if stride == 1:
                y = y.clone()
                v = float(y[0, 5, 7])
                y[0, 5, 7] = v + float(bf16_step(v))
            return y
        tw._conv1d = nudged

    def __exit__(self, *exc):
        tw._conv1d = self.real


def windows_equal(a, b):
    return "".join("=" if np.array_equal(a[0][i], b[0][i]) else "x"
                   for i in range(len(a[0])))


def decode_kernels(n_seeds):
    import test_torch_decode_kernels as td
    for mode in td.MODES:
        for seed in range(n_seeds):
            with pytest.MonkeyPatch.context() as mp:
                for k in td.KNOBS:
                    mp.setenv(k, "1")
                td.route_reference_kernels(mp)
                with jax.disable_jit():
                    win, win_ref = ts._window_slice("bf16", seed=seed,
                                                    **td.MODES[mode])
            print(f"decode kernels {mode} seed={seed} | windows' tokens vs "
                  f"ref {windows_equal(win, win_ref)}", flush=True)


def main(n_seeds):
    torch.set_num_threads(1)
    for d, heads, kernel in tm.FLOAT_BF16_CASES:
        for seed in range(n_seeds):
            cfg, jp, tp, mel = tm._float_bf16_case(d, heads, seed)
            with jax.disable_jit(), jw.kernel_override("interpret"):
                ref = jw.encode(jp, jnp.asarray(mel), cfg,
                                compute_dtype=jnp.bfloat16)
            got = tw.encode(tp, torch.from_numpy(mel), cfg,
                            compute_dtype=torch.bfloat16).float()
            with Nudge():
                nudged = tw.encode(tp, torch.from_numpy(mel), cfg,
                                   compute_dtype=torch.bfloat16).float()
            with jax.disable_jit():
                win, win_ref = ts._window_slice("bf16", cfg=cfg,
                                                quantized=False, seed=seed)
                with Nudge():
                    win_nudged, _ = ts._window_slice(
                        "bf16", cfg=cfg, quantized=False, seed=seed)
            eq = windows_equal
            print(f"{kernel} d={d} heads={heads} seed={seed} | states vs "
                  f"ref: {compare(ref, got)} | vs nudged port: "
                  f"{compare(got, nudged)} | windows' tokens vs ref "
                  f"{eq(win, win_ref)}, vs nudged port "
                  f"{eq(win, win_nudged)}", flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    if "decode" in sys.argv[2:]:
        torch.set_num_threads(1)
        decode_kernels(n)
    else:
        main(n)
