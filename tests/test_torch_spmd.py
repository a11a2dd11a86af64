"""The port's dp serving path (``nobs_whisper_torch/parallel/spmd.py``) on
the CPU: the reference's ``tests/test_spmd.py`` cases, each run on the
port. The gate; the sharded decode against the single-device one; the
framed path, the auto-language path and the beam strategy through the
batcher against the unsharded batcher; the kernels' plain versions called
inside every shard (the CPU stand-in for the per-shard kernels on the
card) with the result close to the unsharded plain path; the shard
context kept to its thread; sampling decorrelated across shards; and
speculative decoding per shard. Tiny configs at f32 unless a case needs
bf16 (the attention kernels' gate); the port's CPU stand-in for the 8
virtual devices is the CPU named 8 times."""

import threading

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tiny_cfg(name="spmd-test", heads=4):
    from nobs_whisper_torch.core.config import WhisperConfig
    return WhisperConfig(
        name=name, n_mels=80, n_vocab=1024, n_audio_ctx=32,
        n_audio_state=128, n_audio_head=heads, n_audio_layer=2,
        n_text_ctx=32, n_text_state=128, n_text_head=heads, n_text_layer=2,
        n_langs=4, eot_id=1000, force_multilingual=True)


def _mesh(dp=8, tp=1):
    from nobs_whisper_torch.parallel.mesh import make_mesh
    return make_mesh(dp=dp, tp=tp, device="cpu")


_OPTS = dict(logprob_threshold=-1e9, entropy_threshold=0.0,
             no_speech_threshold=1.1, compression_ratio_threshold=1e9)


def _frames(cfg, seed, n=4):
    from nobs_whisper_torch.audio.mel import frame_window_np
    from nobs_whisper_torch.utils.testing import speech_like_audio
    return [frame_window_np(speech_like_audio(0.3, seed=seed + i),
                            n_frames=2 * cfg.n_audio_ctx) for i in range(n)]


def _both_batchers(params, cfg, opts, frames, prompt, **submit):
    """(unsharded results, dp=8 mesh results) for the same requests."""
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    out = []
    for kw in (dict(max_batch=4), dict(max_batch=8, mesh=_mesh())):
        b = WindowBatcher(params, cfg, opts=opts, max_wait_ms=50,
                          device="cpu", **kw)
        try:
            futs = [b.submit(None, prompt, frames=f, **submit)
                    for f in frames]
            out.append([f.result(timeout=300) for f in futs])
        finally:
            b.close()
    return out


def test_spmd_gate(monkeypatch):
    from nobs_whisper_torch.parallel.spmd import spmd_serving_enabled
    dp8, dp4tp2 = _mesh(8, 1), _mesh(4, 2)
    assert spmd_serving_enabled(dp8)
    assert not spmd_serving_enabled(dp4tp2)   # tp runs the plain path
    assert not spmd_serving_enabled(None)
    monkeypatch.setenv("NWT_NO_SPMD", "1")
    assert not spmd_serving_enabled(dp8)


def test_spmd_decode_matches_single_device():
    """kind "xa": the sharded decode loop is token-exact against the
    single-device program (each shard runs the same program on its rows;
    the prompts are padded once for the whole batch)."""
    from nobs_whisper_torch.decode.greedy import (decode_window,
                                                  decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import encode, init_params
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    mel = torch.from_numpy(
        np.random.RandomState(1).randn(8, 80, 64).astype(np.float32))
    opts = DecodeOptions()
    tables = build_rule_tables(cfg, opts)
    prompts = [[cfg.sot, cfg.lang_base + (i % 4), cfg.transcribe]
               for i in range(8)]
    xa = encode(params, mel, cfg)
    expected = decode_window(params, xa, prompts, cfg, tables, opts)
    got = decode_window_finalize(decode_window_dispatch(
        params, xa, prompts, cfg, tables, opts, mesh=_mesh()))
    for e, g in zip(expected, got):
        assert g.tokens == e.tokens
        assert g.sum_logprob == pytest.approx(e.sum_logprob, rel=1e-3,
                                              abs=1e-3)
        assert g.no_speech_prob == pytest.approx(e.no_speech_prob,
                                                 rel=1e-3, abs=1e-4)


def test_spmd_frames_path_via_batcher_matches_plain():
    """The serving path (frames -> mel -> encode -> decode) through a
    dp-only-mesh WindowBatcher returns the unsharded batcher's tokens
    (four requests padded to eight rows)."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import init_params
    cfg = _tiny_cfg()
    exp, got = _both_batchers(init_params(0, cfg), cfg,
                              DecodeOptions(**_OPTS), _frames(cfg, 30),
                              [cfg.sot, cfg.lang_base, cfg.transcribe])
    assert [g.tokens for g in got] == [e.tokens for e in exp]


def test_spmd_auto_language_path_matches_plain():
    """Auto language (lang_slot) under the dp batcher: the sharded frames
    -> encode -> detect stage patches the same languages and gives the
    same tokens as the unsharded batcher."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import init_params
    cfg = _tiny_cfg()
    exp, got = _both_batchers(init_params(0, cfg), cfg,
                              DecodeOptions(**_OPTS), _frames(cfg, 40),
                              [cfg.sot, cfg.lang_base, cfg.transcribe],
                              lang_slot=1)
    assert [g.tokens for g in got] == [e.tokens for e in exp]
    assert [g.language for g in got] == [e.language for e in exp]


def _plain(fn):
    """``fn()`` with every kernel gate off (the unsharded plain path)."""
    from nobs_whisper_torch.parallel.tp import ShardContext, shard_context
    with shard_context(ShardContext(None, plain=True)):
        return fn()


def _thread_spies(monkeypatch, names):
    """Record the thread of every call of the given kernels' plain
    versions ({name: (module, attribute)})."""
    seen = {k: [] for k in names}
    for key, (mod, attr) in names.items():
        real = getattr(mod, attr)

        def spy(*a, _real=real, _key=key, **kw):
            seen[_key].append(threading.current_thread().name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, attr, spy)
    return seen


def test_spmd_kernels_fire_inside_shards(monkeypatch):
    """Every shard runs the single-device gates: with an int8 encoder at
    bf16 the K1 and K2 plain versions (what their wrappers run on CPU
    tensors) are called in each of the 8 shard threads, once a layer, and
    the result stays close to the unsharded plain path (kernel noise: the
    kernels' own int8 rounding points and tanh gelu, bf16)."""
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    cfg = _tiny_cfg(name="spmd-kern-test", heads=2)    # dh = 64: K1's pairs
    params = quantize_encoder_params(init_params(3, cfg, torch.bfloat16))
    mel = torch.from_numpy(
        np.random.RandomState(5).randn(8, 80, 64).astype(np.float32))
    seen = _thread_spies(monkeypatch, {
        "K1": (ea, "encoder_attention_fused_qkv_plain"),
        "K2": (fm, "encoder_mlp_int8_resident_plain")})
    expected = _plain(lambda: encode(params, mel, cfg,
                                     torch.bfloat16)).float()
    assert seen == {"K1": [], "K2": []}

    got = encode_spmd(params, mel, _mesh(), cfg, torch.bfloat16).float()
    for k in ("K1", "K2"):
        names = seen[k]
        assert len(names) == 8 * cfg.n_audio_layer, (k, names)
        assert len(set(names)) == 8 and all(n.startswith("nwt-shard-")
                                            for n in names)
    err = (got - expected).abs() / (expected.abs().max() + 1e-6)
    assert float(err.max()) < 5e-2


@pytest.mark.parametrize("level", ["2", "3"])
def test_spmd_fused_attention_fires_inside_shards(monkeypatch, level):
    """NWT_ATTN_FUSED=2 (K1 with the o projection) and =3 (K12, the whole
    layer) under the dp path: the kernel's plain version runs in every
    shard and the result stays close to the unsharded plain path."""
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    cfg = _tiny_cfg(name="spmd-fused-test", heads=2)
    params = quantize_encoder_params(init_params(7, cfg, torch.bfloat16))
    mel = torch.from_numpy(
        np.random.RandomState(9).randn(8, 80, 64).astype(np.float32))
    monkeypatch.setenv("NWT_ATTN_FUSED", level)
    seen = _thread_spies(monkeypatch, {
        "fused": (ea, "encoder_attention_fused_qkv_plain") if level == "2"
        else (fl, "encoder_layer_fused_plain")})
    expected = _plain(lambda: encode(params, mel, cfg,
                                     torch.bfloat16)).float()
    assert seen["fused"] == []
    got = encode_spmd(params, mel, _mesh(), cfg, torch.bfloat16).float()
    assert len(set(seen["fused"])) == 8
    err = (got - expected).abs() / (expected.abs().max() + 1e-6)
    assert float(err.max()) < 5e-2


def test_no_spmd_runs_the_plain_path_per_shard(monkeypatch):
    """``NWT_NO_SPMD`` on a dp mesh: the shards run with every kernel gate
    off, as the reference's GSPMD path does: each shard's states are the
    single-device plain path's on its row, bit for bit."""
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    cfg = _tiny_cfg()
    params = quantize_encoder_params(init_params(3, cfg))
    mel = torch.from_numpy(
        np.random.RandomState(5).randn(8, 80, 64).astype(np.float32))
    monkeypatch.setenv("NWT_NO_SPMD", "1")
    seen = _thread_spies(monkeypatch, {
        "K2": (fm, "encoder_mlp_int8_resident_plain")})
    got = encode_spmd(params, mel, _mesh(), cfg)
    assert seen["K2"] == []
    expected = torch.cat([_plain(lambda: encode(params, mel[i:i + 1], cfg))
                          for i in range(8)])
    assert torch.equal(got, expected)


def test_shard_context_is_thread_local():
    """The shard context (kernels off, tp group) does not leak into
    another thread: a batcher running on the same process while a shard
    holds a plain context keeps its kernels."""
    from nobs_whisper_torch.parallel import tp as T
    seen = {}
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with T.shard_context(T.ShardContext(None, plain=True)):
            entered.set()
            release.wait(timeout=30)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert entered.wait(timeout=30)
        seen["other_thread"] = (T.current(), T.kernels_off())
    finally:
        release.set()
        t.join()
    assert seen["other_thread"] == (None, False)
    assert T.current() is None


def test_spmd_beam_batcher_matches_plain():
    """The beam strategy (opts.beam_size > 1) under a dp mesh: the
    encode/detect stage runs sharded, then each dp group runs the beam
    decode on its rows; tokens and languages equal the unsharded
    batcher's."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import init_params
    cfg = _tiny_cfg()
    exp, got = _both_batchers(init_params(0, cfg), cfg,
                              DecodeOptions(beam_size=2, **_OPTS),
                              _frames(cfg, 50),
                              [cfg.sot, cfg.lang_base, cfg.transcribe],
                              lang_slot=1)
    assert [g.tokens for g in got] == [e.tokens for e in exp]
    assert [g.language for g in got] == [e.language for e in exp]


def test_spmd_sampling_decorrelated_across_shards():
    """temperature > 0 on a dp mesh: each shard's generator is seeded from
    the batch's draw and the shard's index, so rows of one identical
    window in different shards do not draw identical samples (they would
    from one shared seed)."""
    from nobs_whisper_torch.decode.greedy import (decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.parallel.spmd import shard_seeds
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    mel = np.random.RandomState(7).randn(1, 80, 64).astype(np.float32)
    mel = torch.from_numpy(np.repeat(mel, 8, axis=0))
    opts = DecodeOptions(**_OPTS)
    tables = build_rule_tables(cfg, opts)
    prompts = [[cfg.sot, cfg.lang_base, cfg.transcribe]] * 8
    xa = encode(params, mel, cfg)
    got = decode_window_finalize(decode_window_dispatch(
        params, xa, prompts, cfg, tables, opts, temperature=1.0,
        generator=torch.Generator().manual_seed(3), mesh=_mesh()))
    assert len({tuple(r.tokens) for r in got}) > 1, \
        "shards drew identical sample streams"
    seeds = shard_seeds(torch.Generator().manual_seed(3), 8)
    assert len(set(seeds)) == 8
    assert seeds == shard_seeds(torch.Generator().manual_seed(3), 8)


def test_spmd_speculative_decode_matches_single_device():
    """kind "xa" with speculative=K on a dp mesh: each shard runs exact
    speculative greedy (self-draft); tokens equal the single-device
    sequential decode."""
    from nobs_whisper_torch.decode.greedy import (decode_window,
                                                  decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import encode, init_params
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    mel = torch.from_numpy(
        np.random.RandomState(3).randn(8, 80, 64).astype(np.float32))
    opts = DecodeOptions()
    tables = build_rule_tables(cfg, opts)
    prompts = [[cfg.sot, cfg.lang_base + (i % 4), cfg.transcribe]
               for i in range(8)]
    xa = encode(params, mel, cfg)
    expected = decode_window(params, xa, prompts, cfg, tables, opts)
    handle = decode_window_dispatch(params, xa, prompts, cfg, tables, opts,
                                    mesh=_mesh(), speculative=2,
                                    draft_pool=2)
    assert handle.passes is None  # no pass count on a mesh, as the reference
    got = decode_window_finalize(handle)
    for e, g in zip(expected, got):
        assert g.tokens == e.tokens
        assert g.sum_logprob == pytest.approx(e.sum_logprob, rel=1e-3,
                                              abs=2e-2)


def test_mesh_batcher_drops_second_model_draft(caplog):
    """A second-model draft on a mesh batcher is dropped with the
    reference's warning: mesh serving self-drafts."""
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    with caplog.at_level("WARNING"):
        b = WindowBatcher(params, cfg, max_batch=8, device="cpu",
                          speculative=2, draft=(params, cfg),
                          mesh=_mesh())
    try:
        assert b.draft is None and b.speculative == 2
        assert "self-drafts" in caplog.text
    finally:
        b.close()


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2)])
def test_spmd_matches_jax_window_decode(dp, tp):
    """The port's sharded window decode from encoder states gives the JAX
    package's sharded decode's tokens on the same weights at f32 (dp=8:
    the reference's shard_map program; dp=4 x tp=2: its GSPMD one)."""
    import jax
    import jax.numpy as jnp

    from nobs_whisper_tpu.decode.greedy import (
        decode_window_dispatch as jdispatch,
        decode_window_finalize as jfinalize)
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JOpts
    from nobs_whisper_tpu.decode.rules import build_rule_tables as jtables
    from nobs_whisper_tpu.models.whisper import encode as jencode
    from nobs_whisper_tpu.models.whisper import init_params as jinit
    from nobs_whisper_tpu.parallel.mesh import make_mesh as jmake
    from nobs_whisper_tpu.parallel.mesh import shard_params as jshard
    from nobs_whisper_torch.decode.greedy import (decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import params_from_jax
    cfg = _tiny_cfg()
    jparams = jinit(jax.random.PRNGKey(2), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    mel = np.random.RandomState(11).randn(8, 80, 64).astype(np.float32)
    prompts = [[cfg.sot, cfg.lang_base + (i % 4), cfg.transcribe]
               for i in range(8)]
    xa = np.array(jencode(jparams, jnp.asarray(mel), cfg))
    jmesh = jmake(dp=dp, tp=tp)
    ref = jfinalize(jdispatch(
        jshard(jparams, jmesh) if tp > 1 else jparams, jnp.asarray(xa),
        prompts, cfg, jtables(cfg, JOpts()), JOpts(), mesh=jmesh))
    got = decode_window_finalize(decode_window_dispatch(
        params, torch.from_numpy(xa), prompts, cfg,
        build_rule_tables(cfg, DecodeOptions()), DecodeOptions(),
        mesh=_mesh(dp, tp)))
    assert [g.tokens for g in got] == [r.tokens for r in ref]
    for g, r in zip(got, ref):
        assert g.sum_logprob == pytest.approx(r.sum_logprob, abs=1e-3)


@pytest.mark.parametrize("mode", ["beam", "speculative"])
def test_mixed_mesh_strategies_match_plain(mode):
    """The beam strategy and speculative decoding on a dp=2 x tp=2 mesh
    (each dp group over its two tp ranks, which stay in lockstep through
    beam steps and draft/verify passes) give the unsharded batcher's
    tokens, auto language included."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    opts = DecodeOptions(**_OPTS, **({"beam_size": 2} if mode == "beam"
                                     else {"speculative": 2}))
    frames = _frames(cfg, 50)
    prompt = [cfg.sot, cfg.lang_base, cfg.transcribe]
    out = []
    for mesh in (None, _mesh(2, 2)):
        b = WindowBatcher(params, cfg, opts=opts, max_batch=4,
                          max_wait_ms=100, device="cpu", mesh=mesh)
        try:
            futs = [b.submit(None, prompt, frames=f, lang_slot=1)
                    for f in frames]
            out.append([f.result(timeout=300) for f in futs])
        finally:
            b.close()
    assert [g.tokens for g in out[1]] == [e.tokens for e in out[0]]
    assert [g.language for g in out[1]] == [e.language for e in out[0]]


def test_tp_ranks_sample_in_lockstep():
    """Rows above temperature 0 on a tp=2 mesh: the ranks of a group draw
    from generators of one seed, so they sample the same tokens, take the
    same steps and finish together."""
    from nobs_whisper_torch.decode.greedy import (decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.parallel import spmd
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    mel = torch.from_numpy(
        np.random.RandomState(8).randn(2, 80, 64).astype(np.float32))
    opts = DecodeOptions(**_OPTS)
    tables = build_rule_tables(cfg, opts)
    xa = encode(params, mel, cfg)
    prompts = [[cfg.sot, cfg.lang_base, cfg.transcribe]] * 2
    ranks = {}
    real = spmd.run_on_mesh

    def both_ranks(mesh, sparams, body, batch_args=(), out_device=None):
        def keep(p, *a):
            from nobs_whisper_torch.parallel.tp import current
            out = body(p, *a)
            ranks[current().rank] = out[0].clone()
            return out
        return real(mesh, sparams, keep, batch_args, out_device)

    spmd.run_on_mesh = both_ranks
    try:
        got = decode_window_finalize(decode_window_dispatch(
            params, xa, prompts, cfg, tables, opts, temperature=0.9,
            generator=torch.Generator().manual_seed(1), mesh=_mesh(1, 2)))
    finally:
        spmd.run_on_mesh = real
    assert torch.equal(ranks[0], ranks[1])
    assert all(np.isfinite(r.sum_logprob) for r in got)
