"""The frozen operation and byte counts against counts by hand."""

import pytest

from benchmark.ops import arith


def test_attention_block_by_hand():
    # 2 windows of 1500 positions, d 1280: q/k/v 3 x 2 x 3000 x 1280 x 1280
    i8, bf, nbytes = arith.attention_block(2, 1500, 1280)
    assert i8 == 3 * 2 * 3000 * 1280 * 1280
    # scores and PV: 2 x (2 x 1500 x 1500 x 1280) a window
    assert bf == 2 * 2 * (2 * 1500 * 1500 * 1280)
    assert nbytes == (3000 * 1280 * 2 * 2 + 3 * 1280 * 1280 + 3 * 1280 * 4
                      + 4 * 1280 * 4)


def test_mlp_block_by_hand():
    ops, nbytes = arith.mlp_block(1, 1500, 1280, 5120)
    assert ops == 2 * (2 * 1500 * 1280 * 5120)
    assert nbytes == (1500 * 1280 * 2 * 2 + 2 * 1280 * 5120
                      + (5120 + 1280) * 4 * 2 + 2 * 1280 * 4)


def test_bound_takes_the_larger():
    assert arith.bound_s(3.35e12) == pytest.approx(1.0)
    assert arith.bound_s(1.0, int8_ops=1979e12, bf16_flops=989e12) \
        == pytest.approx(2.0)


TURBO = dict(d_model=1280, num_mel_bins=128, encoder_ffn_dim=5120,
             decoder_ffn_dim=5120, encoder_layers=32, decoder_layers=4,
             vocab_size=51866)


def test_encoder_window_by_hand():
    i8, bf = arith.encoder_window(TURBO)
    t, d = 1500, 1280
    assert i8 == 32 * 24 * t * d * d
    assert bf == 2 * 3000 * 3 * 128 * d + 2 * t * 3 * d * d \
        + 32 * 4 * t * t * d


def test_decoder_row_by_hand():
    s, t, d, v = 100, 1500, 1280, 51866
    per = 28 * s * d * d + 4 * s * s * d + 4 * t * d * d + 4 * s * t * d
    assert arith.decoder_row(TURBO, s) == 4 * per + 2 * s * d * v


def test_batch_least_time():
    i8, bf = arith.encoder_window(TURBO)
    got = arith.batch_least_s(TURBO, [10, 20], 48)
    want = (2 * i8 / 1979e12 + (2 * bf + arith.decoder_row(TURBO, 57)
                                + arith.decoder_row(TURBO, 67)) / 989e12)
    assert got == pytest.approx(want)
