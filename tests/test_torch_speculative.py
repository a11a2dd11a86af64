"""Exact speculative greedy decoding: the port against the JAX package at
f32 on the CPU, over every window-level case of ``tests/test_speculative.py``
(perfect draft, adversarial second-model draft, pooled self-draft, ragged
prompts, k=1 and k=4, the phase-2 tail, the 9-layer decoder, quantized
params). Each case holds three things: the port's speculative tokens equal
the JAX package's, which equal the port's sequential greedy tokens; the
pass counts are equal; ``sum_logprob`` is within 2e-2 and
``no_speech_prob`` within 1e-5 of the sequential decode's. Also:
``pool_cross_kv`` bit for bit, ``decoder_forward``'s ``pos_base`` and
``slot_mask`` hooks, the first-eot acceptance clip, the batcher's knobs
and the incompatible-draft error. Both packages decode the same encoder
states (the JAX package's, handed to the port).

The serving paths (batcher, mel and q8, the second-model draft through
``BatchedEngine``, ``/stats``, the CLI) are in
``tests/test_torch_speculative_paths.py``.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load(path):
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    return (JaxEngine.from_ggml(path, dtype=jnp.float32),
            WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu"))


def _window_setup(ref, eng, n, seed):
    """Rule tables of both packages, the JAX package's encoder states of
    ``n`` random mel windows (numpy) and n English prompts."""
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_tpu.models.whisper import encode
    from nobs_whisper_torch.decode import rules as trl
    cfg = eng.cfg
    mels = np.random.RandomState(seed).randn(
        n, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)
    xa = np.array(encode(ref.params, jnp.asarray(mels), ref.cfg))
    prompts = [list(eng.tokenizer.sot_sequence(language="en"))] * n
    return (jr.build_rule_tables(ref.cfg, jr.DecodeOptions(), ref.tokenizer),
            trl.build_rule_tables(cfg, trl.DecodeOptions(), eng.tokenizer),
            xa, prompts)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    d = tmp_path_factory.mktemp("m")
    target, draft = str(d / "target.bin"), str(d / "draft.bin")
    write_tiny_checkpoint(target, seed=0)
    # adversarial draft: same architecture, different random weights
    write_tiny_checkpoint(draft, seed=42)
    ref, eng = _load(target)
    ref_draft, eng_draft = _load(draft)
    jt, tt, xa, prompts = _window_setup(ref, eng, 3, 0)
    return types.SimpleNamespace(
        ref=ref, eng=eng, ref_draft=ref_draft, eng_draft=eng_draft,
        cfg=eng.cfg, jt=jt, tt=tt, xa=xa, prompts=prompts,
        seq=_greedy(eng.params, eng.cfg, tt, xa, prompts))


def _greedy(params, cfg, tables, xa, prompts, **kw):
    """The port's sequential greedy decode."""
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions
    return decode_window(params, torch.from_numpy(xa), prompts, cfg, tables,
                         DecodeOptions(**kw))


def _spec_both(ref_params, params, cfg, jt, tt, xa, prompts, draft=None,
               **kw):
    """Both packages' ``decode_window_speculative`` on the same encoder
    states: ((port results, passes), (JAX results, passes)).
    ``draft``: (JAX engine, port engine) of a second-model draft."""
    from nobs_whisper_tpu.decode.speculative import \
        decode_window_speculative as ref_spec
    from nobs_whisper_torch.decode.speculative import \
        decode_window_speculative
    rd = {} if draft is None else dict(draft_params=draft[0].params,
                                       draft_cfg=draft[0].cfg)
    pd = {} if draft is None else dict(draft_params=draft[1].params,
                                       draft_cfg=draft[1].cfg)
    want = ref_spec(ref_params, jnp.asarray(xa), prompts, cfg, jt,
                    return_passes=True, **rd, **kw)
    got = decode_window_speculative(params, torch.from_numpy(xa), prompts,
                                    cfg, tt, return_passes=True, **pd, **kw)
    return got, want


def _assert_three(seq, got, want):
    (spec, passes), (ref_spec, ref_passes) = got, want
    assert passes == ref_passes
    for a, b, r in zip(seq, spec, ref_spec):
        assert b.tokens == r.tokens == a.tokens
        assert b.sum_logprob == pytest.approx(a.sum_logprob, abs=2e-2)
        assert b.sum_logprob == pytest.approx(r.sum_logprob, abs=2e-2)
        assert b.no_speech_prob == pytest.approx(a.no_speech_prob, abs=1e-5)


def _run(s, prompts=None, **kw):
    return _spec_both(s.ref.params, s.eng.params, s.cfg, s.jt, s.tt, s.xa,
                      prompts or s.prompts, **kw)


def test_perfect_draft_exact_and_fast(setup):
    """Draft == target with no pooling: every draft accepted, so the pass
    count collapses to ~len/(k+1), and the tokens stay exact."""
    got = _run(setup, k_draft=3, draft_pool=1)
    _assert_three(setup.seq, *got)
    longest = max(len(r.tokens) for r in setup.seq) + 1   # + the eot
    assert got[0][1] <= -(-longest // 4) + 1, (got[0][1], longest)


def test_adversarial_draft_exact(setup):
    """A draft with unrelated random weights mostly mismatches; the output
    is still the sequential one, at more passes than a perfect draft."""
    got = _run(setup, k_draft=3, draft_pool=1,
               draft=(setup.ref_draft, setup.eng_draft))
    _assert_three(setup.seq, *got)
    longest = max(len(r.tokens) for r in setup.seq) + 1
    assert got[0][1] > -(-longest // 4) + 1, (got[0][1], longest)


def test_pooled_self_draft_exact(setup):
    """The serving mode: the target drafts over 4x time-pooled cross-KV."""
    _assert_three(setup.seq, *_run(setup, k_draft=3, draft_pool=4))


def test_ragged_prompts_exact(setup):
    """Rows of different prompt lengths (context on one row) stay exact
    through the left-pad machinery."""
    s = setup
    ragged = [list(p) for p in s.prompts]
    ragged[1] = [s.cfg.sot_prev] + s.eng.tokenizer.encode(" hello world") \
        + ragged[1]
    seq = _greedy(s.eng.params, s.cfg, s.tt, s.xa, ragged)
    _assert_three(seq, *_run(s, prompts=ragged, k_draft=2, draft_pool=2))


@pytest.mark.parametrize("k", [1, 4])
def test_k1_and_k4_exact(setup, k):
    """Edge draft depths: k=1 (minimal) and k=4 (deep)."""
    _assert_three(setup.seq, *_run(setup, k_draft=k, draft_pool=2))


def test_pass_budget_phase2_exact(setup):
    """An adversarial draft burns the pass budget (sample_len // 2 = 4
    passes); the sequential phase-2 tail finishes the rows exactly."""
    s = setup
    seq = _greedy(s.eng.params, s.cfg, s.tt, s.xa, s.prompts, sample_len=8)
    got = _run(s, sample_len=8, k_draft=3, draft_pool=1,
               draft=(s.ref_draft, s.eng_draft))
    _assert_three(seq, *got)
    assert got[0][1] > 4, got[0][1]          # phase 2 really ran


def test_deep_decoder_path_exact(tmp_path):
    """A 9-layer decoder (the reference's fori_loop branch; the port has
    one loop for every depth)."""
    from nobs_whisper_torch.utils.testing import (tiny_test_config,
                                                  write_tiny_checkpoint)
    path = str(tmp_path / "deep.bin")
    write_tiny_checkpoint(path, cfg=tiny_test_config(dec_layers=9))
    ref, eng = _load(path)
    assert eng.cfg.n_text_layer > 8
    jt, tt, xa, prompts = _window_setup(ref, eng, 2, 2)
    seq = _greedy(eng.params, eng.cfg, tt, xa, prompts)
    _assert_three(seq, *_spec_both(ref.params, eng.params, eng.cfg, jt, tt,
                                   xa, prompts, k_draft=2, draft_pool=2))


def test_quantized_params_exact(setup):
    """int8 decoder weights (the serving default): speculation matches the
    sequential decode on the quantized params, in both packages."""
    s = setup
    qref, qeng = s.ref.quantize(), s.eng.quantize()
    seq = _greedy(qeng.params, s.cfg, s.tt, s.xa, s.prompts)
    _assert_three(seq, *_spec_both(qref.params, qeng.params, s.cfg, s.jt,
                                   s.tt, s.xa, s.prompts, k_draft=2,
                                   draft_pool=2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [1, 2, 3, 4])
def test_pool_cross_kv_bit_exact(pool, dtype):
    """``pool_cross_kv`` equals the JAX package's bit for bit, at f32 and
    at bf16 (summed in f32 and rounded once, as ``jnp.mean`` does), with
    a T that no pool divides."""
    import ml_dtypes
    from nobs_whisper_tpu.decode.speculative import pool_cross_kv as ref_pool
    from nobs_whisper_torch.decode.speculative import pool_cross_kv
    rng = np.random.RandomState(pool)
    kv = [rng.randn(2, 3, 4, 37, 8).astype(np.float32) for _ in range(2)]
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    want = ref_pool(tuple(jnp.asarray(a.astype(np_dt)) for a in kv), pool)
    got = pool_cross_kv(tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                              for a in kv), pool)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        w = np.asarray(w).astype(np.float32)
        assert g.shape == w.shape == (2, 3, 4, 37 // pool, 8)
        np.testing.assert_array_equal(g.float().numpy(), w)


def test_decoder_forward_hooks_match_reference(setup):
    """``decoder_forward`` with random ``pos_base`` and ``slot_mask`` equals
    the JAX package's at f32 (1e-5), over a prefill and a 3-token block on
    a ragged batch; with ``pos_base = cache_idx - pad`` and an all-True
    ``slot_mask`` it equals the plain call bit for bit."""
    from nobs_whisper_tpu.models import whisper as jw
    from nobs_whisper_torch.models import whisper as tw
    s = setup
    cfg, b, t_len = s.cfg, 3, 24
    rng = np.random.RandomState(11)
    xa = s.xa
    pad = np.array([0, 2, 1])
    prompt = rng.randint(0, 200, (b, 8))
    block = rng.randint(0, 200, (b, 3))
    pos_base = rng.randint(0, 40, b)
    mask = rng.rand(b, t_len) < 0.7
    mask[:, 8:11] = True

    def run_ref():
        cross = jw.precompute_cross_kv(s.ref.params, jnp.asarray(xa), cfg)
        cache = jw.init_kv_cache(cfg, b, t_ctx=t_len)
        _, cache = jw.decoder_forward(s.ref.params, jnp.asarray(prompt), 0,
                                      jnp.asarray(pad), cache, cross, cfg)
        out, _ = jw.decoder_forward(
            s.ref.params, jnp.asarray(block), 8, jnp.asarray(pad), cache,
            cross, cfg, pos_base=jnp.asarray(pos_base),
            slot_mask=jnp.asarray(mask))
        return np.asarray(out)

    def run_port(hooks):
        xt = torch.from_numpy(xa)
        cross = tw.precompute_cross_kv(s.eng.params, xt, cfg)
        cache = tw.init_kv_cache(cfg, b, t_ctx=t_len)
        padt = torch.from_numpy(pad)
        _, cache = tw.decoder_forward(s.eng.params, torch.from_numpy(prompt),
                                      0, padt, cache, cross, cfg)
        out, _ = tw.decoder_forward(s.eng.params, torch.from_numpy(block), 8,
                                    padt, cache, cross, cfg, **hooks)
        return out.numpy()

    got = run_port(dict(pos_base=torch.from_numpy(pos_base),
                        slot_mask=torch.from_numpy(mask)))
    np.testing.assert_allclose(got, run_ref(), atol=1e-5, rtol=1e-5)
    plain = run_port({})
    same = run_port(dict(pos_base=torch.from_numpy(8 - pad),
                         slot_mask=torch.ones(b, t_len, dtype=torch.bool)))
    np.testing.assert_array_equal(plain, same)
    assert not np.array_equal(plain, got)


def test_acceptance_clips_at_the_first_eot():
    """A target row with two eots: acceptance stops at the FIRST (the
    reference's ``jnp.argmax(is_eot, 1)``), and a row with none gives
    K + 1; ``torch.argmax`` takes no bool, so the helper casts."""
    from nobs_whisper_torch.decode.speculative import _first_true
    eot, k = 7, 3
    targets = np.array([[1, eot, 2, eot], [eot, eot, 3, 4], [1, 2, 3, 4],
                        [1, 2, 3, eot]])
    is_eot = targets == eot
    want = np.asarray(jnp.where(jnp.any(is_eot, 1),
                                jnp.argmax(jnp.asarray(is_eot), 1), k + 1))
    got = _first_true(torch.from_numpy(is_eot), k + 1)
    assert got.tolist() == want.tolist() == [1, 0, k + 1, 3]


@pytest.mark.parametrize("env, kw, want", [
    ({"NWT_SPECULATIVE": "3"}, {}, (3, 4)),
    ({"NWT_SPECULATIVE": "3", "NWT_DRAFT_POOL": "8"}, {}, (3, 8)),
    ({"NWT_SPECULATIVE": "3", "NWT_DRAFT_POOL": "8"},
     dict(speculative=2, draft_pool=4), (2, 4)),
    ({"NWT_SPECULATIVE": "x", "NWT_DRAFT_POOL": "y"}, {}, (0, 4)),
    ({"NWT_SPECULATIVE": "x"}, dict(speculative=2), (2, 4)),
])
def test_batcher_env_knobs(setup, monkeypatch, caplog, env, kw, want):
    """``NWT_SPECULATIVE``/``NWT_DRAFT_POOL`` fill the batcher's defaults;
    an explicit value wins (an explicit draft_pool=4 too); a malformed
    value is logged and ignored. Both packages agree."""
    from nobs_whisper_tpu.pipeline.batcher import WindowBatcher as RefBatcher
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    s = setup
    got = WindowBatcher(s.eng.params, s.cfg, s.eng.tokenizer, device="cpu",
                        **kw)
    ref = RefBatcher(s.ref.params, s.ref.cfg, s.ref.tokenizer, **kw)
    try:
        assert (got.speculative, got.draft_pool) == want == \
            (ref.speculative, ref.draft_pool)
    finally:
        got.close()
        ref.close()
    if "x" in env.values() and "speculative" not in kw:
        assert "malformed NWT_SPECULATIVE" in caplog.text


def test_incompatible_draft_raises(setup):
    """A draft whose vocabulary or encoder width differs from the target's
    is refused at construction, in both packages, with the same message."""
    from nobs_whisper_tpu.pipeline.batcher import WindowBatcher as RefBatcher
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    from nobs_whisper_torch.utils.testing import tiny_test_config
    s = setup
    for bad in (tiny_test_config(n_vocab=2048), tiny_test_config(d=128)):
        with pytest.raises(ValueError, match="draft model incompatible") \
                as e:
            WindowBatcher(s.eng.params, s.cfg, s.eng.tokenizer,
                          speculative=2, draft=(s.eng_draft.params, bad),
                          device="cpu")
        with pytest.raises(ValueError) as r:
            RefBatcher(s.ref.params, s.ref.cfg, s.ref.tokenizer,
                       speculative=2, draft=(s.ref_draft.params, bad))
        assert str(e.value) == str(r.value)
