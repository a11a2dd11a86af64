"""The port's beam search (``nobs_whisper_torch/decode/beam.py``) against
the JAX package's on the CPU: the step bookkeeping on handmade cases
(``tests/test_beam.py``'s five and a tie case), whole windows on the same
weights (``params_from_jax``) and the same seeded mel as
``tests/test_decode.py``'s oracle setup, batch against solo, the shared
packed cross-KV against the plain one, ``NWT_BEAM_ANCESTRY``, the golden
``beam_tokens``, and the bf16 serving configuration against the reference
run op by op.

Tokens are compared exactly. At f32 the scores are sums of a few dozen
log-probabilities that differ by summation order only: 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# beam_step: the reference's handmade cases and a tie case
# ---------------------------------------------------------------------------

def _lp(rows):
    return np.asarray(rows, np.float32)[None]


def _case_first():
    # K=2, V=4; beam 1 has a huge score that must be ignored at step 0
    lp = np.log(_lp([[0.5, 0.3, 0.15, 0.05], [0.25, 0.25, 0.25, 0.25]]))
    return dict(cum=[[0.0, 100.0]], lp=lp, first=True)


def _case_global():
    lp = np.full((1, 2, 4), -10.0, np.float32)
    lp[0, 0, 0], lp[0, 1, 1] = -0.2, -0.05
    return dict(cum=[[0.0, -0.1]], lp=lp)


def _case_eot():
    lp = np.full((1, 2, 4), -10.0, np.float32)
    lp[0, 0, 3], lp[0, 0, 0], lp[0, 1, 1] = -0.1, -0.5, -0.7
    return dict(cum=[[0.0, 0.0]], lp=lp)


def _case_full_pool():
    lp = np.full((1, 2, 4), -10.0, np.float32)
    lp[0, 0, 3], lp[0, 1, 0] = -0.01, -0.2
    return dict(cum=[[0.0, 0.0]], lp=lp, fin_valid=[[True, True]])


def _case_low_eot(eot_lp):
    lp = np.full((1, 2, 4), -10.0, np.float32)
    lp[0, 0, 0], lp[0, 1, 1], lp[0, 0, 3] = -0.2, -0.3, eot_lp
    return dict(cum=[[0.0, 0.0]], lp=lp)


def _case_ties():
    """Equal scores across tokens and beams, as bf16 logits give: the top
    2K and the actives must come in index order (``torch.topk`` promises
    no order among equal values; on a CPU build it ordered
    [1, 3, 3, 2, 3, 0]'s top 3 as [2, 4, 1]). Two eot finishers tie too.
    K=3, V=6, eot=5."""
    lp = np.full((2, 3, 6), -4.0, np.float32)
    lp[0, 0] = [-1.0, -0.5, -0.5, -2.0, -0.5, -0.25]
    lp[0, 1] = [-0.5, -4.0, -0.5, -4.0, -4.0, -0.25]
    lp[0, 2] = [-3.0, -0.5, -4.0, -4.0, -4.0, -3.0]
    lp[1] = np.log(np.float32(1 / 6))              # all equal
    return dict(cum=[[0.0, 0.0, 0.0], [-1.0, -1.0, -1.0]], lp=lp, eot=5,
                fin_valid=[[False, False, False], [True, False, False]])


CASES = {"first_expands_only_beam0": _case_first(),
         "selects_global_top_k": _case_global(),
         "eot_goes_to_finished": _case_eot(),
         "full_pool_discards_new_finishers": _case_full_pool(),
         "low_ranked_eot_not_collected": _case_low_eot(-0.5),
         "eot_above_kth_active_finishes": _case_low_eot(-0.25),
         "ties_in_index_order": _case_ties()}


def _both_steps(case):
    from nobs_whisper_tpu.decode.beam import beam_step as jstep
    from nobs_whisper_torch.decode.beam import beam_step as tstep
    lp = case["lp"]
    cum = np.asarray(case["cum"], np.float32)
    fin = np.asarray(case.get("fin_valid", np.zeros(cum.shape, bool)))
    eot, first = case.get("eot", 3), case.get("first", False)
    ref = [np.asarray(x) for x in jstep(
        jnp.asarray(cum), jnp.asarray(lp), jnp.asarray(fin), eot,
        jnp.asarray(first))]
    got = [x.numpy() for x in tstep(torch.from_numpy(cum),
                                    torch.from_numpy(lp),
                                    torch.from_numpy(fin), eot, first)]
    return got, ref


@pytest.mark.parametrize("name", list(CASES))
def test_beam_step_matches_reference(name):
    """Every output of the port's step equals the reference's: sources,
    tokens and the finisher order exactly, scores bit for bit (the same
    f32 additions)."""
    got, ref = _both_steps(CASES[name])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_beam_step_semantics():
    """The reference's checklist (``tests/test_beam.py``) on the port."""
    def step(name):
        return _both_steps(CASES[name])[0]

    src, tok, cum, *_ = step("first_expands_only_beam0")
    assert (src == 0).all() and list(tok[0]) == [0, 1]
    src, tok, cum, *_ = step("selects_global_top_k")
    assert list(src[0]) == [1, 0] and list(tok[0]) == [1, 0]
    np.testing.assert_allclose(cum[0], [-0.15, -0.2], rtol=1e-5)
    src, tok, cum, slot, fsrc, fscore = step("eot_goes_to_finished")
    assert slot[0, 0] == 0 and fsrc[0, 0] == 0 and slot[0, 1] >= 2
    assert fscore[0, 0] == pytest.approx(-0.1, rel=1e-5) and 3 not in tok[0]
    assert (step("full_pool_discards_new_finishers")[3][0] >= 2).all()
    assert (step("low_ranked_eot_not_collected")[3][0] >= 2).all()
    slot, _, fscore = step("eot_above_kth_active_finishes")[3:]
    assert slot[0, 0] == 0 and fscore[0, 0] == pytest.approx(-0.25)
    src, tok, cum, slot, fsrc, fscore = step("ties_in_index_order")
    # element 0: -0.25 eot finishers of beams 0 and 1 (tied, beam 0
    # first); the -0.5 actives in flat-index order
    assert list(src[0]) == [0, 0, 0] and list(tok[0]) == [1, 2, 4]
    assert list(fsrc[0][:2]) == [0, 1] and list(slot[0][:2]) == [0, 1]
    # element 1: all 18 candidates tie; the pool's one filled slot puts
    # the first finisher at slot 1
    assert list(src[1]) == [0, 0, 0] and list(tok[1]) == [0, 1, 2]
    assert slot[1, 0] >= 3


# ---------------------------------------------------------------------------
# whole windows: tests/test_decode.py's tiny oracle model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    from tests.test_decode import _special_layout
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration
    from nobs_whisper_tpu.core.config import WhisperConfig
    from nobs_whisper_tpu.core.hf import params_from_hf_state_dict
    from nobs_whisper_torch.models.whisper import params_from_jax

    sp = _special_layout()
    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=sp["n_vocab"], num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        decoder_ffn_dim=256, encoder_ffn_dim=256,
        max_source_positions=64, max_target_positions=96,
        activation_function="gelu", pad_token_id=sp["eot"],
        bos_token_id=sp["eot"], eos_token_id=sp["eot"],
        decoder_start_token_id=sp["sot"],
        suppress_tokens=None, begin_suppress_tokens=None)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    cfg = WhisperConfig(
        name="beam-test", n_mels=80, n_vocab=sp["n_vocab"],
        n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
        n_text_ctx=96, n_text_state=64, n_text_head=4, n_text_layer=2,
        n_langs=4, eot_id=sp["eot"], force_multilingual=True)
    jp = params_from_hf_state_dict(model.model.state_dict(), cfg)
    tp = params_from_jax(jax.tree.map(lambda a: np.array(a, np.float32), jp))
    return jp, tp, cfg, sp


def _tables(cfg):
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JOpts
    from nobs_whisper_tpu.decode.rules import build_rule_tables as jtables
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    return (jtables(cfg, JOpts(suppress_blank=True)),
            build_rule_tables(cfg, DecodeOptions(suppress_blank=True)))


def _xa(jp, cfg, seed, batch=1):
    """Encoder states of a seeded mel, by the JAX package's encoder: both
    decoders start from the same values."""
    from nobs_whisper_tpu.models.whisper import encode
    mel = np.random.RandomState(seed).randn(batch, 80, 128).astype(np.float32)
    return np.asarray(encode(jp, jnp.asarray(mel), cfg))


def _both(setup, seed, batch=1, beam_size=5, sample_len=40, **kw):
    from nobs_whisper_tpu.decode.beam import beam_decode_window as jbeam
    from nobs_whisper_torch.decode.beam import beam_decode_window as tbeam
    jp, tp, cfg, sp = setup
    jt, tt = _tables(cfg)
    xa = _xa(jp, cfg, seed, batch)
    prompts = [[sp["sot"], sp["lang0"], sp["transcribe"]]] * batch
    ref = jbeam(jp, jnp.asarray(xa), prompts, cfg, jt, beam_size=beam_size,
                sample_len=sample_len)
    got = tbeam(tp, torch.from_numpy(xa), prompts, cfg, tt,
                beam_size=beam_size, sample_len=sample_len)
    return got, ref


def _assert_same(got, ref, rtol=1e-4):
    for g, r in zip(got, ref):
        assert g.tokens == r.tokens
        assert g.sum_logprob == pytest.approx(r.sum_logprob, rel=rtol)
        assert g.avg_logprob == pytest.approx(r.avg_logprob, rel=rtol)
        assert g.no_speech_prob == pytest.approx(r.no_speech_prob,
                                                 rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_beam_window_matches_reference_f32(setup, seed):
    """Beam 5 over 40 steps on ``tests/test_decode.py``'s oracle seeds
    (mel seed 100 + seed): tokens exact, scores 1e-4 relative."""
    got, ref = _both(setup, 100 + seed)
    assert len(got) == 1
    _assert_same(got, ref)


def test_beam_batch_matches_solo(setup):
    """A batch of three elements gives each element's solo result."""
    from nobs_whisper_torch.decode.beam import beam_decode_window
    jp, tp, cfg, sp = setup
    _, tt = _tables(cfg)
    xa = torch.from_numpy(_xa(jp, cfg, 9, batch=3))
    prompt = [sp["sot"], sp["lang0"], sp["transcribe"]]
    batch = beam_decode_window(tp, xa, [prompt] * 3, cfg, tt, beam_size=3)
    for i in range(3):
        solo = beam_decode_window(tp, xa[i:i + 1], [prompt], cfg, tt,
                                  beam_size=3)[0]
        assert batch[i].tokens == solo.tokens
        assert batch[i].avg_logprob == pytest.approx(solo.avg_logprob,
                                                     abs=1e-3)


def test_beam_ragged_batch_matches_reference(setup):
    """Ragged prompts (one with a previous-text prefix) in one batch,
    beam 3, against the reference."""
    from nobs_whisper_tpu.decode.beam import beam_decode_window as jbeam
    from nobs_whisper_torch.decode.beam import beam_decode_window as tbeam
    jp, tp, cfg, sp = setup
    jt, tt = _tables(cfg)
    xa = _xa(jp, cfg, 11, batch=2)
    prompts = [[sp["sot"], sp["lang0"], sp["transcribe"]],
               [sp["sot_prev"], 5, 6, 7, sp["sot"], sp["lang0"] + 1,
                sp["transcribe"]]]
    ref = jbeam(jp, jnp.asarray(xa), prompts, cfg, jt, beam_size=3,
                sample_len=30)
    got = tbeam(tp, torch.from_numpy(xa), prompts, cfg, tt, beam_size=3,
                sample_len=30)
    _assert_same(got, ref)


def _bf16(tp):
    return {k: (_bf16(v) if isinstance(v, dict) else
                v.to(torch.bfloat16) if v.is_floating_point() else v)
            for k, v in tp.items()}


def test_beam_shared_packed_cross_kv_matches_plain(setup, monkeypatch):
    """At bf16, the packed cross-KV shared by an element's beams (the
    grouped cross-attention of the serving path) gives the beams of the
    plain cross-KV repeated per beam (``tests/test_beam.py``'s check and
    bound), and decodes K x B rows against B cross-KV sets."""
    from nobs_whisper_torch.decode.beam import beam_decode_window
    from nobs_whisper_torch.models import whisper as tw
    jp, tp, cfg, sp = setup
    _, tt = _tables(cfg)
    p16 = _bf16(tp)
    for seed, batch in ((0, 1), (3, 2)):
        xa = torch.from_numpy(_xa(jp, cfg, seed, batch)).to(torch.bfloat16)
        prompts = [[sp["sot"], sp["lang0"], sp["transcribe"]]] * batch
        monkeypatch.setenv("NWT_NO_KT_XATTN", "1")
        plain = beam_decode_window(p16, xa, prompts, cfg, tt, beam_size=3,
                                   compute_dtype=torch.bfloat16)
        monkeypatch.delenv("NWT_NO_KT_XATTN")
        monkeypatch.setenv("NWT_FORCE_KT", "1")
        tw.decoder_forward_calls.clear()
        shared = beam_decode_window(p16, xa, prompts, cfg, tt, beam_size=3,
                                    compute_dtype=torch.bfloat16)
        monkeypatch.delenv("NWT_FORCE_KT")
        assert {(lay, b) for lay, b, _ in tw.decoder_forward_calls} == \
            {("grouped", 3 * batch)}
        for pl_r, sh_r in zip(plain, shared):
            assert sh_r.tokens == pl_r.tokens, f"seed {seed}"
            assert sh_r.sum_logprob == pytest.approx(pl_r.sum_logprob,
                                                     abs=5e-2)


@pytest.mark.parametrize("seed,batch", [(0, 1), (3, 2), (7, 3)])
def test_beam_ancestry_matches_permuted_and_reference(setup, monkeypatch,
                                                      seed, batch):
    """``NWT_BEAM_ANCESTRY=1`` (self-attention through ancestry pointers,
    no cache permutation) gives the permuted path's tokens, and the
    reference's under the same knob; scores to f32 reassociation."""
    from nobs_whisper_tpu.decode.beam import beam_decode_window as jbeam
    from nobs_whisper_torch.decode.beam import beam_decode_window as tbeam
    jp, tp, cfg, sp = setup
    jt, tt = _tables(cfg)
    xa = _xa(jp, cfg, seed, batch)
    prompts = [[sp["sot"], sp["lang0"], sp["transcribe"]]] * batch
    base = tbeam(tp, torch.from_numpy(xa), prompts, cfg, tt, beam_size=3)
    monkeypatch.setenv("NWT_BEAM_ANCESTRY", "1")
    jax.clear_caches()          # the reference reads the knob at trace time
    try:
        anc = tbeam(tp, torch.from_numpy(xa), prompts, cfg, tt, beam_size=3)
        ref = jbeam(jp, jnp.asarray(xa), prompts, cfg, jt, beam_size=3)
    finally:
        jax.clear_caches()
    for b_r, a_r in zip(base, anc):
        assert a_r.tokens == b_r.tokens
        assert a_r.sum_logprob == pytest.approx(b_r.sum_logprob, abs=1e-3)
    _assert_same(anc, ref)


def test_ancestry_attention_equals_permuted_rows():
    """The ancestry attention over a cache in place equals plain attention
    over the cache permuted row by row along each position's ancestry."""
    from nobs_whisper_torch.models.whisper import (_attention_kt,
                                                   _attention_kt_ancestry)
    g = torch.Generator().manual_seed(0)
    b, k, h, dh, t = 2, 3, 2, 8, 12
    q = torch.randn(b * k, h, 1, dh, generator=g)
    kT = torch.randn(b * k, h, dh, t, generator=g)
    v = torch.randn(b * k, h, t, dh, generator=g)
    anc = torch.randint(0, k, (b * k, t), generator=g)
    mask = (torch.arange(t) < 9).reshape(1, 1, 1, t).expand(b * k, 1, 1, t)
    rows = (torch.arange(b * k) // k * k)[:, None] + anc      # (BK, T)
    kT_p = kT[rows, :, :, torch.arange(t)].permute(0, 2, 3, 1)
    v_p = v[rows, :, torch.arange(t)].permute(0, 2, 1, 3)
    want = _attention_kt(q, kT_p, v_p, mask)
    got = _attention_kt_ancestry(q, kT, v, mask, anc, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_beam_golden_tokens():
    """The frozen oracle golden (``tests/goldens/oracle_tiny.npz``): beam 5,
    40 steps, tokens equal and the sum within the golden test's bound."""
    from tests.test_torch_kernels_gpu import _golden_model
    from nobs_whisper_torch.decode.beam import beam_decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    z, params, cfg = _golden_model("cpu")
    tables = build_rule_tables(cfg, DecodeOptions(suppress_blank=True))
    res = beam_decode_window(params, torch.from_numpy(z["xa"]),
                             [z["prompt"].tolist()], cfg, tables,
                             beam_size=5, sample_len=40)[0]
    assert res.tokens == z["beam_tokens"].tolist()
    assert res.sum_logprob == pytest.approx(float(z["beam_sum_logprob"]),
                                            rel=1e-3, abs=1e-3)


def test_beam_bf16_serving_config_matches_reference_op_by_op(monkeypatch):
    """The configuration that is served: bf16 compute, an int8 decoder at
    dh=64, the packed cross-KV shared by the beams (grouped
    cross-attention), beam 5 over two ragged elements, against the
    reference at jnp.bfloat16 run op by op (``jax.disable_jit``), as
    ``tests/test_torch_slice.py`` holds greedy: the bf16 function as
    written, every op rounded to bf16 (8 steps: the op-by-op reference
    takes seconds a step). Tokens equal; scores 1e-3
    relative (a bf16 step of the final hidden state moves a logit by
    ~1e-2; see that file)."""
    from nobs_whisper_tpu.decode.beam import beam_decode_window as jbeam
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JOpts
    from nobs_whisper_tpu.decode.rules import build_rule_tables as jtables
    from nobs_whisper_tpu.models import whisper as jw
    from nobs_whisper_tpu.ops.quant import quantize_decoder_params
    from nobs_whisper_tpu.utils.testing import tiny_test_config
    from nobs_whisper_torch.decode.beam import beam_decode_window as tbeam
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models import whisper as tw

    monkeypatch.setenv("NWT_FORCE_KT", "1")   # the reference's TPU default
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32, n_text_ctx=64)
    jp = quantize_decoder_params(jw.init_params(jax.random.PRNGKey(7), cfg,
                                                dtype=jnp.bfloat16))
    tp = tw.params_from_jax(jax.tree.map(
        lambda a: np.array(a) if a.dtype == np.int8
        else np.array(a, np.float32), jp), dtype=torch.bfloat16)
    xa = (np.random.RandomState(5).randn(2, cfg.n_audio_ctx, cfg.n_audio_state)
          ).astype(np.float32)
    xa16 = np.asarray(jnp.asarray(xa, jnp.bfloat16).astype(jnp.float32))
    prompts = [[cfg.sot, cfg.lang_base, cfg.transcribe],
               [cfg.sot_prev, 300, 301, cfg.sot, cfg.lang_base + 1,
                cfg.transcribe]]
    with jax.disable_jit():
        ref = jbeam(jp, jnp.asarray(xa16, jnp.bfloat16), prompts, cfg,
                    jtables(cfg, JOpts()), beam_size=5, sample_len=8,
                    compute_dtype=jnp.bfloat16)
    got = tbeam(tp, torch.from_numpy(xa16).to(torch.bfloat16), prompts, cfg,
                build_rule_tables(cfg, DecodeOptions()), beam_size=5,
                sample_len=8, compute_dtype=torch.bfloat16)
    _assert_same(got, ref, rtol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_beam.py's model-level properties, on the port
# ---------------------------------------------------------------------------

def _port_greedy_and_beam(setup, seed, beam_size):
    from nobs_whisper_torch.decode.beam import beam_decode_window
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions
    jp, tp, cfg, sp = setup
    _, tt = _tables(cfg)
    xa = torch.from_numpy(_xa(jp, cfg, seed))
    prompt = [sp["sot"], sp["lang0"], sp["transcribe"]]
    g = decode_window(tp, xa, [prompt], cfg, tt,
                      DecodeOptions(suppress_blank=True))[0]
    b = beam_decode_window(tp, xa, [prompt], cfg, tt,
                           beam_size=beam_size)[0]
    return g, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam1_matches_greedy(setup, seed):
    """beam_size=1 is greedy by construction when a finished beam
    exists."""
    g, b = _port_greedy_and_beam(setup, seed, 1)
    assert b.tokens == g.tokens
    assert b.sum_logprob == pytest.approx(g.sum_logprob, abs=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_beam5_no_worse_than_greedy(setup, seed):
    g, b = _port_greedy_and_beam(setup, seed, 5)
    assert b.avg_logprob >= g.avg_logprob - 1e-4


def test_beam_rules_respected(setup):
    """The timestamp rules hold on the beam's pick: it starts with a
    timestamp and never emits sot or no-timestamps."""
    _, b = _port_greedy_and_beam(setup, 5, 5)
    sp = setup[3]
    if b.tokens:
        assert b.tokens[0] >= sp["ts_begin"]
    assert all(t not in (sp["sot"], sp["no_ts"]) for t in b.tokens)
