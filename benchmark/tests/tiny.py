"""A cell shrunk to a size the CPU runs in seconds, for the harness's
tests: two encoder and two decoder layers of width 128 (two heads of 64,
so the encoder takes the int8 kernels' plain versions), the published
vocabulary, window and text context."""

from __future__ import annotations

import os
import time

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell(workload: str, rows: int = 4, sample_len: int = 16,
         check_requests: int = 2) -> harness.Cell:
    c = harness.load_cell(ROOT, workload)
    c.model = dict(c.model, d_model=128, encoder_layers=2, decoder_layers=2,
                   encoder_attention_heads=2, decoder_attention_heads=2,
                   encoder_ffn_dim=512, decoder_ffn_dim=512)
    c.model["serving"] = dict(c.model["serving"], max_batch=rows)
    mix = dict(c.mix, check=dict(c.mix["check"], requests=check_requests))
    mix["decode"] = dict(mix["decode"], sample_len=sample_len)
    if mix["kind"] == "open_poisson":
        mix["rate_per_s"] = 2.0
    else:
        mix.update(clients=rows, pool=2 * rows,
                   batcher=dict(max_batch=rows, max_wait_ms=500.0))
    c.mix = mix
    c.limits = dict(c.limits, tokens_judged_min=check_requests * sample_len)
    return c


def run(c: harness.Cell, seed: int, seconds: float = 3.0,
        control_bits=None) -> dict:
    """The whole run but the look for a card, on the CPU."""
    return harness.execute(c, seed, seconds, False, time.perf_counter(),
                           device="cpu", control_bits=control_bits)
