"""The mesh's multi-card path on the cards: every decode kernel that sets
its attributes at its first launch (K4, K5, K6's decode and prefill
kernels, K7) launched on each visible card in turn and held to its plain
version, and a dp=2 batcher over two cards against the unsharded batcher
on one.

``cudaFuncSetAttribute`` acts on a kernel in the current device's context
only, so a kernel that recorded "done" once per process launched on the
second card without its shared-memory size and its permission for
clusters over 8 blocks (K6's split-K clusters reach 16). The kernels now
record it once a device (``csrc/common.cuh::DeviceFlags``).

Marked ``gpu``; skips with fewer than two cards (the CPU suite runs the
mesh on the CPU in ``tests/test_torch_parallel.py`` and
``tests/test_torch_spmd.py``). Imports neither JAX nor the JAX package;
from the repo root, on a machine with two cards or more:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_mesh_gpu.py

Tolerances are the single-card tests' (``tests/test_torch_kernels_gpu.py``):
K4 and K5 one bf16 step elementwise, K6 1e-3 absolute plus 1e-3 relative,
K7 with bf16 x one bf16 step.
"""

import numpy as np
import pytest
import torch

from nobs_whisper_torch.ops import attention_pallas as ap
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops import quant as qt
from nobs_whisper_torch.ops.quant import quantize_int8

pytestmark = pytest.mark.gpu

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K6_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: the second card's first launch "
                    "is what these tests hold")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _k6(dev, m):
    """fc2's shape (5120 x 1280): K6's split-K cluster is 14 blocks."""
    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn(m, 5120, generator=g, device=dev).to(torch.bfloat16)
    w = quantize_int8(torch.randn(5120, 1280, generator=g, device=dev)
                      * 5120 ** -0.5)
    np.testing.assert_allclose(qt.q8_matmul(x, w).cpu().numpy(),
                               qt.q8_matmul_plain(x, w).cpu().numpy(),
                               **K6_TOL)


def _k7(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = rn(8, 1280).to(torch.bfloat16)
    args = (1.0 + 0.1 * rn(1280), 0.1 * rn(1280),
            quantize_int8(rn(1280, 5120) * 1280 ** -0.5), 0.1 * rn(5120),
            quantize_int8(rn(5120, 1280) * 5120 ** -0.5), 0.1 * rn(1280))
    got = fm.fused_mlp_q8(x, *args).float()
    ref = fm.fused_mlp_q8_plain(x, *args).float()
    torch.testing.assert_close(got, ref, **BF16_STEP)


def _cross(dev, q8):
    """Turbo's decode step at B=1: 20 heads of 64 over 1500 positions."""
    g = torch.Generator(device=dev).manual_seed(30)
    q = (torch.randn(1, 20, 1, 64, generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    k = torch.randn(1, 1, 20, 1500, 64, generator=g, device=dev)
    v = torch.randn(1, 1, 20, 1500, 64, generator=g, device=dev)
    if q8:
        kq, vq = ap.quantize_cross_kv((k, v))
        kq, vq = ({z: w[0] for z, w in kq.items()},
                  {z: w[0] for z, w in vq.items()})
        got = ap.cross_attention_decode_q8(q, kq, vq)
        ref = ap.cross_attention_decode_q8_plain(q, kq, vq)
    else:
        kT, vv = ap.pack_cross_kv_bf16((k, v))
        packed = {"kT": kT["kT"][0], "v": vv["v"][0]}
        got = ap.cross_attention_decode_bf16(q, packed, 1500)
        ref = ap.cross_attention_decode_bf16_plain(q, packed, 1500)
    torch.testing.assert_close(got.float(), ref.float(), **BF16_STEP)


KERNELS = {"K4": lambda d: _cross(d, False), "K5": lambda d: _cross(d, True),
           "K6-decode": lambda d: _k6(d, 8), "K6-prefill": lambda d: _k6(d, 64),
           "K7": _k7}


@pytest.mark.parametrize("name", list(KERNELS))
def test_decode_kernel_on_every_card(cards, name):
    """Each card in turn, from a context on that card (the shard threads'
    way), launches the kernel and matches its plain version."""
    for dev in cards:
        with torch.cuda.device(dev):
            KERNELS[name](dev)
        torch.cuda.synchronize(dev)


def test_dp2_batcher_on_two_cards(cards):
    """A dp=2 batcher over cuda:0 and cuda:1 (a shard a card, each in its
    own host thread) gives the unsharded batcher's tokens, on a dh=64 int8
    model at f32 (K2's f32 variant in every shard, TF32 off)."""
    from nobs_whisper_torch.audio.mel import frame_window_np
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.ops.quant import (quantize_decoder_params,
                                              quantize_encoder_params)
    from nobs_whisper_torch.parallel.mesh import make_mesh
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    from nobs_whisper_torch.utils.testing import (speech_like_audio,
                                                  tiny_test_config)
    cfg = tiny_test_config(d=128, heads=2)
    params = quantize_encoder_params(quantize_decoder_params(
        init_params(3, cfg, device=cards[0])))
    frames = [frame_window_np(speech_like_audio(0.4, seed=40 + i),
                              n_frames=2 * cfg.n_audio_ctx) for i in range(4)]
    prompt = [cfg.sot, cfg.lang_base, cfg.transcribe]
    opts = DecodeOptions(temperature_increment=0.0, sample_len=24)
    out = []
    for mesh in (None, make_mesh(dp=2, devices=cards[:2])):
        b = WindowBatcher(params, cfg, opts=opts, max_batch=4,
                          max_wait_ms=2000, device=cards[0], mesh=mesh)
        try:
            futs = [b.submit(None, prompt, frames=f) for f in frames]
            out.append([f.result(timeout=300).tokens for f in futs])
        finally:
            b.close()
    assert out[1] == out[0]
