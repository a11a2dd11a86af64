"""What the greedy decode step needs to be captured in a CUDA graph
(``decode/greedy.py``), on the CPU: ``decoder_forward`` with its cache
position as a 0-d device tensor gives the int path's bits; the cached
constants (``core/device.py::scalar``) are ``torch.tensor``'s bits, one
object per value, dtype and device, and leave the logit rules unchanged;
launches counted while a graph is captured are added once a replay
(``ops/_build.py::LaunchTally``). The CPU runs the steps eagerly; the
graph itself is held to the eager loop on the card
(``tests/test_torch_decode_graph_gpu.py``)."""

import math

import numpy as np
import pytest
import torch

from nobs_whisper_torch.core.device import scalar
from nobs_whisper_torch.decode import rules as rl
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.ops import _build
from nobs_whisper_torch.ops.quant import quantize_decoder_params
from nobs_whisper_torch.utils.testing import tiny_test_config

CFG = tiny_test_config()
P = 6        # prompt tokens before the step


def _setup(dtype, layout, seed=3):
    """Params, encoder states, prompts and pads, and the decode loop's
    cross-KV of ``layout`` ("plain", "packed", "q8" on int8 weights)."""
    from nobs_whisper_torch.decode.greedy import window_cross_kv
    params = tw.init_params(seed, CFG, dtype=dtype)
    if layout == "q8":
        params = quantize_decoder_params(params)
    rng = np.random.RandomState(seed)
    b = 3
    xa = torch.from_numpy(rng.randn(b, CFG.n_audio_ctx, CFG.n_audio_state)
                          .astype(np.float32)).to(dtype)
    tokens = torch.from_numpy(rng.randint(0, CFG.eot, (b, P + 1)))
    pads = torch.tensor([0, 2, 5])
    cross = window_cross_kv(params, xa, CFG, layout == "q8",
                            layout == "packed")
    return params, tokens, pads, cross


def _forward(params, tokens, start, pads, cache, cross, dtype):
    return tw.decoder_forward(params, tokens, start, pads, cache, cross,
                              CFG, dtype)


@pytest.mark.parametrize("layout", ["plain", "packed", "q8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, P], ids=["step", "prefill"])
def test_a_tensor_cache_position_gives_the_int_paths_bits(s, dtype, layout):
    """The prefill at position 0 (S = P), or one step at position P after
    the prefill (S = 1): logits and every cache entry bit for bit."""
    params, tokens, pads, cross = _setup(dtype, layout)
    outs = []
    for as_tensor in (False, True):
        cache = tw.init_kv_cache(CFG, 3, dtype=dtype, t_ctx=16)
        start = 0
        if s == 1:
            _forward(params, tokens[:, :P], 0, pads, cache, cross, dtype)
            start = P
        step = tokens[:, start:start + s]
        pos = torch.tensor(start) if as_tensor else start
        logits, (ck, cv) = _forward(params, step, pos, pads, cache, cross,
                                    dtype)
        outs.append((logits, ck, cv))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


VALUES = (rl.NEG_INF, math.sqrt(0.5), 64 ** -0.25, 0.044715,
          math.sqrt(2 / math.pi), -0.0, 1e-7, 3)
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("v", VALUES, ids=repr)
def test_a_cached_constant_has_torch_tensors_bits(v, dtype):
    want = torch.tensor(v, dtype=dtype)
    got = scalar(v, dtype, "cpu")
    assert got.dtype == dtype and got.shape == () and got.device == want.device
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[want.element_size()]
    assert torch.equal(got.view(bits), want.view(bits))
    assert scalar(v, dtype, torch.device("cpu")) is got


def test_one_constant_per_value_dtype_and_device():
    a = scalar(0.5, torch.float32, "cpu")
    assert scalar(0.5, torch.bfloat16, "cpu") is not a
    assert scalar(0.25, torch.float32, "cpu") is not a
    # -0.0 == 0.0, but their bits differ
    assert scalar(-0.0, torch.float32, "cpu") is not scalar(
        0.0, torch.float32, "cpu")
    assert scalar(7, torch.long, "cpu") is scalar(7, torch.long, "cpu")


@pytest.mark.parametrize("timestamps", [True, False])
def test_the_rules_are_unchanged_with_the_cached_constant(monkeypatch,
                                                          timestamps):
    """The rules on random logits and states, with the cached -1e30 and
    with a ``torch.tensor`` made at each call, as before."""
    opts = rl.DecodeOptions(timestamps=timestamps)
    tables = rl.build_rule_tables(CFG, opts)
    rng = np.random.RandomState(1)
    b, tb = 6, CFG.timestamp_begin
    logits = torch.from_numpy(rng.randn(b, CFG.n_vocab).astype(np.float32))
    state = dict(
        n_sampled=torch.tensor([0, 1, 2, 3, 5, 9]),
        last_token=torch.tensor([0, tb + 3, tb + 1, 7, tb, CFG.eot]),
        penult_token=torch.tensor([0, 0, tb, tb + 2, 11, tb + 4]),
        max_ts_token=torch.tensor([tb - 1, tb + 3, tb + 1, tb + 2, tb,
                                   tb + 4]))
    got = rl.apply_logit_rules_scored(logits, tables, **state)
    monkeypatch.setattr(rl, "scalar", lambda v, dtype, device: torch.tensor(
        v, dtype=dtype, device=device))
    want = rl.apply_logit_rules_scored(logits, tables, **state)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_a_replayed_step_counts_its_forward():
    """Launches counted while a graph is captured go to the capture's
    tally, not to the counters: a capture launches nothing. Each replay
    adds them."""
    params, tokens, pads, cross = _setup(torch.float32, "packed")
    cache = tw.init_kv_cache(CFG, 3, t_ctx=16)
    key = ("packed", 3, 1)
    before = tw.decoder_forward_calls[key]
    with _build.LaunchTally() as tally:
        _forward(params, tokens[:, :1], torch.tensor(0), pads, cache, cross,
                 torch.float32)
    assert tw.decoder_forward_calls[key] == before
    for n in (1, 2, 3):
        tally.replay()
        assert tw.decoder_forward_calls[key] == before + n
    _forward(params, tokens[:, 1:2], 1, pads, cache, cross, torch.float32)
    assert tw.decoder_forward_calls[key] == before + 4


def test_a_constant_first_made_in_inference_mode_serves_autograd():
    """The decode loop runs under ``torch.inference_mode``; training's
    backward saves the same constants (``x * c`` keeps ``c``)."""
    with torch.inference_mode():
        c = scalar(0.1234567, torch.float32, "cpu")
    assert not c.is_inference()
    x = torch.ones(3, requires_grad=True)
    (x * c).sum().backward()
    assert torch.equal(x.grad, c.expand(3))
