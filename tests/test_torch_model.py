"""Module-level parity of the PyTorch port against the JAX package on the
CPU: weights, mel, encoder, decoder, rules, tokenizer and the frozen
goldens. Inputs are made with numpy from seeds and cross as numpy arrays.

Tolerances: f32 paths differ only by summation order and the op-level
rounding of two CPU backends (TF32 off; the reference pins ``highest``
precision), so f32 values are held to 1e-5 relative / 1e-5 absolute and
the goldens to the JAX tests' own bounds (2e-4). The int8 encoder differs
additionally by int8 ties that summation order can flip and by bf16 k/v/p
rounding inside K1 (one bf16 step is 2^-8 relative), held to 2e-2 like the
JAX kernel tests.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nobs_whisper_tpu.models import whisper as jw
from nobs_whisper_tpu.utils.testing import tiny_test_config
from nobs_whisper_torch.core.config import WhisperConfig as TorchConfig
from nobs_whisper_torch.models import whisper as tw

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np_tree(params):
    return jax.tree.map(lambda a: np.array(a, np.float32)
                        if a.dtype != np.int8 else np.array(a), params)


def _assert_tree_equal(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_tree_equal(ref[k], got[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(ref), got.float().numpy()
                                      if got.is_floating_point()
                                      else got.numpy(), err_msg=path)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_same_weights_as_reference(seed):
    cfg = tiny_test_config()
    ref = _np_tree(jw.init_params(jax.random.PRNGKey(seed), cfg))
    _assert_tree_equal(ref, tw.init_params(seed, cfg))


def test_fuse_qkv_matches_reference():
    from nobs_whisper_tpu.ops.quant import fuse_qkv as jax_fuse
    from nobs_whisper_torch.ops.quant import fuse_qkv
    cfg = tiny_test_config()
    jp = jw.init_params(jax.random.PRNGKey(2), cfg)
    want = _np_tree(jax_fuse(jp))["decoder"]["blocks"]
    got = fuse_qkv(tw.params_from_jax(_np_tree(jp)))["decoder"]["blocks"]
    _assert_tree_equal(want, got)


def test_params_from_jax_keeps_layout_and_qtensors():
    from nobs_whisper_tpu.ops.quant import (quantize_decoder_params,
                                            quantize_encoder_params)
    cfg = tiny_test_config()
    jp = quantize_encoder_params(quantize_decoder_params(
        jw.init_params(jax.random.PRNGKey(1), cfg)))
    tp = tw.params_from_jax(_np_tree(jp), dtype=torch.bfloat16)
    q = tp["encoder"]["blocks"]["fc1_w"]
    assert q["q"].dtype == torch.int8 and q["s"].dtype == torch.float32
    assert tuple(q["q"].shape) == (cfg.n_audio_layer, cfg.n_audio_state,
                                   cfg.ffn_dim)
    assert tuple(q["s"].shape) == (cfg.n_audio_layer, 1, cfg.ffn_dim)
    assert tp["decoder"]["tok_emb_q"]["q"].shape == (cfg.n_audio_state,
                                                     cfg.n_vocab)
    assert tp["encoder"]["conv1_w"].dtype == torch.bfloat16
    _assert_tree_equal(jax.tree.map(np.asarray, jp["encoder"]["blocks"]
                                    ["q_w"]), tp["encoder"]["blocks"]["q_w"])


def test_params_from_ggml_matches_reference(tmp_path):
    from nobs_whisper_tpu.core.ggml import read_ggml as jax_read
    from nobs_whisper_torch.core.ggml import read_ggml
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path / "tiny.bin")
    write_tiny_checkpoint(path, seed=3)
    ref = _np_tree(jw.params_from_ggml(jax_read(path)))
    _assert_tree_equal(ref, tw.params_from_ggml(read_ggml(path)))


# ---------------------------------------------------------------------------
# mel
# ---------------------------------------------------------------------------

def test_framing_and_mel_match_reference():
    from nobs_whisper_tpu.audio import mel as jm
    from nobs_whisper_torch.audio import mel as tm
    rng = np.random.RandomState(0)
    audio = (0.1 * rng.randn(16000 * 7 + 37)).astype(np.float32)
    fr = tm.frame_window_np(audio)
    np.testing.assert_array_equal(fr, jm.frame_window_np(audio))
    n = tm.n_real_frames(len(audio))
    assert n == jm.n_real_frames(len(audio))
    ref = np.asarray(jm.log_mel_from_frames(jnp.asarray(fr[None, :n]),
                                            n_mels=80, n_frames=3000))
    got = tm.log_mel_from_frames(torch.from_numpy(fr[None, :n].copy()),
                                 n_mels=80, n_frames=3000).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    # the f64 oracle: fp32 deviates only in near-zero spectral bins
    oracle = jm.log_mel_numpy_f64(np.concatenate(
        [audio, np.zeros(480000, np.float32)]))[:, :3000]
    assert np.abs(got[0] - oracle).max() < 2e-3
    np.testing.assert_allclose(
        tm.log_mel_longform(audio, n_mels=80),
        jm.log_mel_longform(audio, n_mels=80), rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def test_encoder_f32_matches_reference():
    cfg = tiny_test_config()
    jp = jw.init_params(jax.random.PRNGKey(0), cfg)
    mel = np.random.RandomState(1).randn(2, 80, 128).astype(np.float32)
    ref = np.asarray(jw.encode(jp, jnp.asarray(mel), cfg))
    got = tw.encode(tw.params_from_jax(_np_tree(jp)), torch.from_numpy(mel),
                    cfg).numpy()
    np.testing.assert_allclose(got, ref, **F32)


def _dh64_cfg():
    return tiny_test_config(d=128, heads=2, n_audio_ctx=32, n_text_ctx=64)


def test_int8_encoder_through_kernels_matches_interpret():
    """dh=64: the K1 and K2 gates fire; the port runs their plain versions,
    the reference runs the Pallas kernels in interpret mode."""
    from nobs_whisper_tpu.ops.quant import quantize_encoder_params as jq
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    cfg = _dh64_cfg()
    jp = jq(jw.init_params(jax.random.PRNGKey(2), cfg))
    tp = tw.params_from_jax(_np_tree(jp))
    assert tw.encoder_kernel_gates(cfg, tp["encoder"]["blocks"],
                                   torch.float32, "cpu") == (True, True)
    mel = np.random.RandomState(4).randn(2, 80, 64).astype(np.float32)
    with jw.kernel_override("interpret"):
        ref = np.asarray(jw.encode(jp, jnp.asarray(mel), cfg))
    calls = {"k1": 0, "k2": 0}
    real1, real2 = ea.encoder_attention_fused_qkv_plain, \
        fm.encoder_mlp_int8_resident_plain

    def spy1(*a, **k):
        calls["k1"] += 1
        return real1(*a, **k)

    def spy2(*a, **k):
        calls["k2"] += 1
        return real2(*a, **k)

    ea.encoder_attention_fused_qkv_plain = spy1
    fm.encoder_mlp_int8_resident_plain = spy2
    try:
        got = tw.encode(tp, torch.from_numpy(mel), cfg).numpy()
    finally:
        ea.encoder_attention_fused_qkv_plain = real1
        fm.encoder_mlp_int8_resident_plain = real2
    assert calls == {"k1": cfg.n_audio_layer, "k2": cfg.n_audio_layer}
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_int8_encoder_gates_follow_reference_at_any_dtype():
    """The gates test no dtype, as in the reference: the CPU runs the
    kernels' plain versions at f32 and bf16 alike. Off the CPU the kernels
    take bf16 only, so an int8 encoder at f32 compute raises there, both
    at ``encode`` and at ``WhisperEngine.quantize``, instead of running
    another function."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    cfg = _dh64_cfg()
    blocks = quantize_encoder_params(
        tw.init_params(2, cfg))["encoder"]["blocks"]
    for dt in (torch.float32, torch.bfloat16):
        assert tw.encoder_kernel_gates(cfg, blocks, dt, "cpu") == (True, True)
    assert tw.encoder_kernel_gates(cfg, blocks, torch.bfloat16,
                                   "cuda") == (True, True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tw.encoder_kernel_gates(cfg, blocks, torch.float32, "cuda")
    eng = WhisperEngine.from_random("tiny-test", dtype=torch.float32,
                                    device="cpu")
    eng = dataclasses.replace(eng, cfg=cfg, params=tw.init_params(2, cfg),
                              device=torch.device("meta"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.quantize()
    meta = quantize_encoder_params(tw.init_params(2, cfg, device="meta"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tw.encode(meta, torch.zeros(1, 80, 64, device="meta"), cfg)


def test_int8_encoder_without_kernel_geometry_matches_xla_path():
    """dh=16 (no head pairs of 128 lanes, width not a 128 multiple): both
    sides take the dense_int8_dynamic path."""
    from nobs_whisper_tpu.ops.quant import quantize_encoder_params as jq
    cfg = tiny_test_config()
    jp = jq(jw.init_params(jax.random.PRNGKey(3), cfg))
    mel = np.random.RandomState(5).randn(1, 80, 128).astype(np.float32)
    ref = np.asarray(jw.encode(jp, jnp.asarray(mel), cfg))
    got = tw.encode(tw.params_from_jax(_np_tree(jp)), torch.from_numpy(mel),
                    cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _decoder_case(quantized=False, seed=0, fused=False):
    from nobs_whisper_tpu.ops.quant import fuse_qkv, quantize_decoder_params
    cfg = tiny_test_config()
    jp = jw.init_params(jax.random.PRNGKey(seed), cfg)
    if quantized:
        jp = quantize_decoder_params(jp)
    if fused:
        jp = fuse_qkv(jp)
    rng = np.random.RandomState(seed + 10)
    xa = rng.randn(2, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32)
    return cfg, jp, tw.params_from_jax(_np_tree(jp)), xa


@pytest.mark.parametrize("quantized,fused", [(False, False), (True, False),
                                             (True, True)])
def test_prefill_and_steps_match_decoder_forward(quantized, fused):
    """Ragged left-padded prefill, then two single-token steps; plain,
    int8 and int8 with the fused (d, 3d) q/k/v projection."""
    cfg, jp, tp, xa = _decoder_case(quantized, fused=fused)
    toks = np.array([[cfg.eot, cfg.eot, cfg.sot, cfg.lang_base, 5],
                     [cfg.sot, cfg.lang_base + 1, cfg.transcribe, 7, 9]],
                    np.int32)
    pad = np.array([2, 0], np.int32)
    jkv = jw.precompute_cross_kv(jp, jnp.asarray(xa), cfg)
    tkv = tw.precompute_cross_kv(tp, torch.from_numpy(xa), cfg)
    np.testing.assert_allclose(tkv[0].numpy(), np.asarray(jkv[0]), **F32)
    jc = jw.init_kv_cache(cfg, 2, t_ctx=16)
    tc = tw.init_kv_cache(cfg, 2, t_ctx=16)
    pos = 0
    for step_toks in (toks, np.array([[11], [12]], np.int32),
                      np.array([[13], [14]], np.int32)):
        jl, jc = jw.decoder_forward(jp, jnp.asarray(step_toks),
                                    jnp.int32(pos), jnp.asarray(pad), jc,
                                    jkv, cfg)
        tl, tc = tw.decoder_forward(tp, torch.from_numpy(step_toks).long(),
                                    pos, torch.from_numpy(pad).long(), tc,
                                    tkv, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        pos += step_toks.shape[1]
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), **F32)
    np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]), **F32)


def test_packed_cross_kv_decoder_matches_reference():
    """The serving cross-attention layout: bf16 K pre-transposed and
    padded to 128 positions, scores and PV in f32."""
    from nobs_whisper_tpu.ops.attention_pallas import pack_cross_kv_bf16 as jpk
    from nobs_whisper_torch.ops.attention_pallas import pack_cross_kv_bf16
    cfg, jp, tp, xa = _decoder_case(seed=4)
    jkv = jpk(jw.precompute_cross_kv(jp, jnp.asarray(xa), cfg))
    tkv = pack_cross_kv_bf16(tw.precompute_cross_kv(
        tp, torch.from_numpy(xa), cfg))
    assert tkv[0]["kT"].shape == tuple(jkv[0]["kT"].shape)
    np.testing.assert_allclose(tkv[0]["kT"].float().numpy(),
                               np.asarray(jkv[0]["kT"], np.float32), **F32)
    toks = np.array([[cfg.sot, cfg.lang_base, cfg.transcribe]] * 2, np.int32)
    pad = np.zeros(2, np.int32)
    jl, _ = jw.decoder_forward(jp, jnp.asarray(toks), jnp.int32(0),
                               jnp.asarray(pad), jw.init_kv_cache(cfg, 2, t_ctx=8),
                               jkv, cfg)
    tl, _ = tw.decoder_forward(tp, torch.from_numpy(toks).long(), 0,
                               torch.zeros(2, dtype=torch.long),
                               tw.init_kv_cache(cfg, 2, t_ctx=8), tkv, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timestamps", [True, False])
def test_logit_rules_match_reference(timestamps):
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_torch.decode import rules as trl
    cfg = tiny_test_config()
    rng = np.random.RandomState(7 + timestamps)
    b, tb = 6, cfg.timestamp_begin
    logits = (3 * rng.randn(b, cfg.n_vocab)).astype(np.float32)
    logits[1, tb:] += 6.0                    # fires the probability-mass rule
    n_sampled = np.array([0, 1, 2, 3, 5, 9], np.int32)
    last = np.array([0, tb + 3, 17, tb + 4, tb + 6, 40], np.int32)
    penult = np.array([0, 0, tb + 2, tb + 1, 21, tb + 8], np.int32)
    max_ts = np.array([tb - 1, tb + 3, tb + 2, tb + 4, tb + 6, tb + 8],
                      np.int32)
    jo = jr.DecodeOptions(timestamps=timestamps)
    ref = jr.apply_logit_rules_scored(
        jnp.asarray(logits), jr.build_rule_tables(cfg, jo),
        n_sampled=jnp.asarray(n_sampled), last_token=jnp.asarray(last),
        penult_token=jnp.asarray(penult), max_ts_token=jnp.asarray(max_ts))
    got = trl.apply_logit_rules_scored(
        torch.from_numpy(logits),
        trl.build_rule_tables(cfg, trl.DecodeOptions(timestamps=timestamps)),
        n_sampled=torch.from_numpy(n_sampled).long(),
        last_token=torch.from_numpy(last).long(),
        penult_token=torch.from_numpy(penult).long(),
        max_ts_token=torch.from_numpy(max_ts).long())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **F32)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_host_gates_match_reference():
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_torch.decode import rules as trl
    toks = [5, 5, 5, 7] * 10
    assert trl.token_entropy(toks) == jr.token_entropy(toks)
    for text in ("", "abc abc abc abc abc abc abc", "hello world"):
        assert trl.compression_ratio(text) == jr.compression_ratio(text)
    for args in ((-1.5, 3.0, 40), (-0.2, 1.0, 40), (-0.2, 3.0, 10)):
        for nsp in (None, 0.9, 0.1):
            assert trl.needs_fallback(*args, trl.DecodeOptions(),
                                      no_speech_prob=nsp) == \
                jr.needs_fallback(*args, jr.DecodeOptions(),
                                  no_speech_prob=nsp)
    assert trl.is_no_speech(0.9, -2.0, trl.DecodeOptions())
    assert not trl.is_no_speech(0.9, -0.5, trl.DecodeOptions())


# ---------------------------------------------------------------------------
# goldens (oracle-pinned, loaded without JAX on the port side)
# ---------------------------------------------------------------------------

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "oracle_tiny.npz")


@pytest.fixture(scope="module")
def goldens():
    z = np.load(GOLDENS)
    params = {}
    for key in z.files:
        if not key.startswith("params["):
            continue
        path = re.findall(r"\['([^']+)'\]", key)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = z[key]
    c = json.loads(bytes(z["cfg_json"]).decode())
    cfg = TorchConfig(name="goldens-tiny", force_multilingual=True, **c)
    return z, tw.params_from_jax(params), cfg


def test_encoder_matches_golden(goldens):
    z, params, cfg = goldens
    xa = tw.encode(params, torch.from_numpy(z["mel"]), cfg)
    np.testing.assert_allclose(xa.numpy(), z["xa"], rtol=2e-4, atol=2e-5)


def test_prefill_logits_match_golden(goldens):
    z, params, cfg = goldens
    xa = torch.from_numpy(z["xa"])
    logits, _ = tw.decoder_forward(
        params, torch.from_numpy(z["prompt"]).long()[None], 0,
        torch.zeros(1, dtype=torch.long), tw.init_kv_cache(cfg, 1),
        tw.precompute_cross_kv(params, xa, cfg), cfg)
    np.testing.assert_allclose(logits.numpy(), z["prefill_logits"],
                               rtol=2e-4, atol=2e-4)


def test_greedy_tokens_match_golden(goldens):
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    z, params, cfg = goldens
    opts = DecodeOptions(suppress_blank=True)
    res = decode_window(params, torch.from_numpy(z["xa"]),
                        [z["prompt"].tolist()], cfg,
                        build_rule_tables(cfg, opts), opts)[0]
    assert res.tokens == z["greedy_tokens"].tolist()
    assert res.sum_logprob == pytest.approx(float(z["greedy_sum_logprob"]),
                                            rel=1e-3, abs=1e-3)
    assert res.no_speech_prob == pytest.approx(
        float(z["greedy_no_speech_prob"]), rel=1e-3, abs=1e-6)


# ---------------------------------------------------------------------------
# tokenizer and prompts
# ---------------------------------------------------------------------------

def test_tokenizer_matches_reference():
    from nobs_whisper_tpu.core.tokenizer import WhisperTokenizer as JT
    from nobs_whisper_torch.core.tokenizer import WhisperTokenizer
    from nobs_whisper_torch.utils.testing import byte_level_vocab
    cfg = tiny_test_config()
    vocab = byte_level_vocab(cfg)
    ref, tok = JT(vocab, cfg), WhisperTokenizer(vocab, cfg)
    assert tok._enc is None                 # tiktoken not touched yet
    for text in (" ", "a", " hello there, the world", "x"):
        assert tok.encode(text) == ref.encode(text)
    ids = ref.encode(" the thing") + [cfg.timestamp_begin + 3, cfg.eot]
    assert tok.decode(ids) == ref.decode(ids)
    assert tok.decode_with_timestamps(ids) == ref.decode_with_timestamps(ids)
    assert tok.sot_sequence("de", "translate") == \
        ref.sot_sequence("de", "translate")


def test_pad_prompts_matches_reference():
    from nobs_whisper_tpu.decode.greedy import pad_prompts as jpad
    from nobs_whisper_torch.decode.greedy import pad_prompts
    prompts = [[1, 2, 3], list(range(40)), [9]]
    for a, b in zip(pad_prompts(prompts, 999), jpad(prompts, 999)):
        np.testing.assert_array_equal(a, b)
