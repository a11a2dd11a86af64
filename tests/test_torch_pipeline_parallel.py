"""The port's pipeline (pp) and sequence (sp) parallelism
(``nobs_whisper_torch/parallel/pipeline.py``, ``seqparallel.py``) on the
CPU: a twin of each test of the reference's
``tests/test_pipeline_parallel.py`` with its tolerances (1e-5 on the
encode, 1e-3 on the gradients), each also held to the JAX package's own
``encode_pipelined`` / ``encode_seq_parallel`` on its 8 virtual CPU
devices on the same inputs. The port's CPU stand-in for the 8 devices is
the CPU named 8 times."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(layers=4, ctx=32, name="pp-test"):
    from nobs_whisper_torch.core.config import WhisperConfig as TC
    from nobs_whisper_tpu.core.config import WhisperConfig as JC
    kw = dict(name=name, n_mels=80, n_vocab=1024, n_audio_ctx=ctx,
              n_audio_state=128, n_audio_head=4, n_audio_layer=layers,
              n_text_ctx=32, n_text_state=128, n_text_head=4,
              n_text_layer=2, n_langs=4, eot_id=1000,
              force_multilingual=True)
    return JC(**kw), TC(**kw)


def _inputs(jcfg, batch=8, seed=0):
    """The JAX package's params and mel, and the port's copies."""
    from nobs_whisper_torch.models.whisper import params_from_jax
    from nobs_whisper_tpu.models.whisper import init_params
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    mel = np.random.RandomState(seed).randn(
        batch, jcfg.n_mels, 2 * jcfg.n_audio_ctx).astype(np.float32)
    return (jp, jnp.asarray(mel),
            params_from_jax(jax.tree.map(np.asarray, jp)),
            torch.from_numpy(mel))


def _pp(pp, dp):
    from nobs_whisper_torch.parallel.pipeline import make_pp_mesh
    return make_pp_mesh(pp=pp, dp=dp, device="cpu")


def _sp(sp):
    from nobs_whisper_torch.parallel.seqparallel import make_sp_mesh
    return make_sp_mesh(sp, device="cpu")


def _close(got, *wants, tol=1e-5):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# twins of the reference's tests, each also held to the JAX package
# ---------------------------------------------------------------------------

def test_pp_encode_matches_single_device():
    from nobs_whisper_torch.models.whisper import encode
    from nobs_whisper_torch.parallel.pipeline import encode_pipelined
    from nobs_whisper_tpu.parallel import pipeline as jpp
    jcfg, tcfg = _cfgs(layers=4)
    jp, jmel, p, mel = _inputs(jcfg)
    expected = encode(p, mel, tcfg).numpy()
    mesh = _pp(4, 2)
    assert mesh.shape == {"dp": 2, "pp": 4}
    got = encode_pipelined(p, mel, tcfg, mesh).numpy()
    ref = jpp.encode_pipelined(jp, jmel, jcfg, jpp.make_pp_mesh(pp=4, dp=2))
    _close(got, expected, ref)


def test_pp_only_mesh_and_more_microbatches():
    """pp without dp; n_micro > pp exercises the drained-queue phase."""
    from nobs_whisper_torch.models.whisper import encode
    from nobs_whisper_torch.parallel.pipeline import encode_pipelined
    from nobs_whisper_tpu.parallel import pipeline as jpp
    jcfg, tcfg = _cfgs(layers=8)
    jp, jmel, p, mel = _inputs(jcfg, batch=8, seed=1)
    expected = encode(p, mel, tcfg).numpy()

    got = encode_pipelined(p, mel, tcfg, _pp(8, 1), n_micro=8).numpy()
    ref = jpp.encode_pipelined(jp, jmel, jcfg, jpp.make_pp_mesh(pp=8, dp=1),
                               n_micro=8)
    _close(got, expected, ref)

    mesh2 = _pp(2, 4)
    got2 = encode_pipelined(p, mel, tcfg, mesh2, n_micro=2).numpy()
    ref2 = jpp.encode_pipelined(jp, jmel, jcfg,
                                jpp.make_pp_mesh(pp=2, dp=4), n_micro=2)
    _close(got2, expected, ref2)

    with pytest.raises(ValueError, match="divisible by dp"):
        # mb = 8/4 = 2 not divisible by dp=4
        encode_pipelined(p, mel, tcfg, mesh2, n_micro=4)
    with pytest.raises(ValueError):
        jpp.encode_pipelined(jp, jmel, jcfg, jpp.make_pp_mesh(pp=2, dp=4),
                             n_micro=4)
    with pytest.raises(ValueError, match="n_micro"):
        encode_pipelined(p, mel, tcfg, mesh2, n_micro=3)


def test_pp_rejects_indivisible_layers():
    from nobs_whisper_torch.parallel.pipeline import encode_pipelined
    from nobs_whisper_tpu.parallel import pipeline as jpp
    jcfg, tcfg = _cfgs(layers=2)  # 2 layers over pp=4
    jp, jmel, p, mel = _inputs(jcfg)
    with pytest.raises(ValueError, match="n_audio_layer 2"):
        encode_pipelined(p, mel, tcfg, _pp(4, 2))
    with pytest.raises(ValueError):
        jpp.encode_pipelined(jp, jmel, jcfg, jpp.make_pp_mesh(pp=4, dp=2))


def test_pp_schedule_is_differentiable():
    """Autograd records the GPipe schedule (the stage hand-offs are
    ``.to()`` copies), so the gradient wrt the input flows back through
    every stage: equal to the single-device encode's, and to the JAX
    package's through its ``ppermute`` scan."""
    from nobs_whisper_torch.models.whisper import _encode
    from nobs_whisper_torch.parallel.pipeline import encode_pipelined
    from nobs_whisper_torch.parallel.tp import plain_ops
    from nobs_whisper_tpu.parallel import pipeline as jpp
    jcfg, tcfg = _cfgs(layers=4)
    jp, jmel, p, mel = _inputs(jcfg, batch=8)
    mesh = _pp(4, 2)

    x = mel.clone().requires_grad_(True)
    (encode_pipelined(p, x, tcfg, mesh) ** 2).sum().backward()
    x_ref = mel.clone().requires_grad_(True)
    with plain_ops():
        (_encode(p, x_ref, tcfg, torch.float32) ** 2).sum().backward()
    jmesh = jpp.make_pp_mesh(pp=4, dp=2)
    g_jax = jax.grad(lambda m: jnp.sum(
        jpp.encode_pipelined(jp, m, jcfg, jmesh) ** 2))(jmel)
    _close(x.grad, x_ref.grad, g_jax, tol=1e-3)
    assert float(x.grad.abs().max()) > 0


def test_pp_grad_wrt_params_matches_single_device():
    """Gradients wrt the pp-split layer stack itself (the fine-tuning
    case: cotangents flow back through the stage hand-offs into each
    stage's slice of the stacked weights), the conv stem and ln_post."""
    from nobs_whisper_torch.models.training import trainable_params
    from nobs_whisper_torch.models.whisper import _encode
    from nobs_whisper_torch.parallel.pipeline import encode_pipelined
    from nobs_whisper_torch.parallel.tp import plain_ops
    from nobs_whisper_tpu.parallel import pipeline as jpp
    jcfg, tcfg = _cfgs(layers=4)
    jp, jmel, p, mel = _inputs(jcfg, batch=8)
    mesh = _pp(4, 2)
    tp_pp = trainable_params(p, device="cpu")
    tp_one = trainable_params(p, device="cpu")
    (encode_pipelined(tp_pp, mel, tcfg, mesh) ** 2).sum().backward()
    with plain_ops():
        (_encode(tp_one, mel, tcfg, torch.float32) ** 2).sum().backward()
    jmesh = jpp.make_pp_mesh(pp=4, dp=2)
    g_jax = jax.grad(lambda q: jnp.sum(
        jpp.encode_pipelined(q, jmel, jcfg, jmesh) ** 2))(jp)["encoder"]
    for key in ("blocks", "conv1_w", "ln_post_g"):
        got, one = tp_pp["encoder"][key], tp_one["encoder"][key]
        ref = g_jax[key]
        if key != "blocks":
            got, one, ref = {key: got}, {key: one}, {key: ref}
        for name in got:
            np.testing.assert_allclose(
                got[name].grad.numpy(), one[name].grad.numpy(), atol=1e-3,
                rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(
                got[name].grad.numpy(), np.asarray(ref[name]), atol=1e-3,
                rtol=1e-3, err_msg=name)


def test_sp_encode_matches_single_device():
    from nobs_whisper_torch.models.whisper import encode
    from nobs_whisper_torch.parallel.seqparallel import encode_seq_parallel
    from nobs_whisper_tpu.parallel import seqparallel as jsp
    jcfg, tcfg = _cfgs(layers=4)
    jp, jmel, p, mel = _inputs(jcfg, seed=2)
    expected = encode(p, mel, tcfg).numpy()
    mesh = _sp(8)
    assert mesh.shape == {"sp": 8}
    got = encode_seq_parallel(p, mel, tcfg, mesh).numpy()
    ref = jsp.encode_seq_parallel(jp, jmel, jcfg, jsp.make_sp_mesh(sp=8))
    _close(got, expected, ref)


def test_pp_sp_reject_quantized_params():
    """int8 QTensor leaves raise the documented precondition at entry, in
    both packages."""
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.parallel.pipeline import encode_pipelined
    from nobs_whisper_torch.parallel.seqparallel import encode_seq_parallel
    from nobs_whisper_tpu.ops.quant import quantize_encoder_params as jq
    from nobs_whisper_tpu.parallel import pipeline as jpp
    from nobs_whisper_tpu.parallel import seqparallel as jsp
    jcfg, tcfg = _cfgs(layers=4)
    jp, jmel, p, mel = _inputs(jcfg)
    qparams = quantize_encoder_params(p)
    with pytest.raises(ValueError, match="unquantized"):
        encode_pipelined(qparams, mel, tcfg, _pp(4, 2))
    with pytest.raises(ValueError, match="unquantized"):
        encode_seq_parallel(qparams, mel, tcfg, _sp(8))
    with pytest.raises(ValueError, match="unquantized"):
        jpp.encode_pipelined(jq(jp), jmel, jcfg, jpp.make_pp_mesh(pp=4, dp=2))
    with pytest.raises(ValueError, match="unquantized"):
        jsp.encode_seq_parallel(jq(jp), jmel, jcfg, jsp.make_sp_mesh(sp=8))


def test_sp_rejects_indivisible_t():
    from nobs_whisper_torch.parallel.seqparallel import encode_seq_parallel
    from nobs_whisper_tpu.parallel import seqparallel as jsp
    jcfg, tcfg = _cfgs(layers=2, ctx=30, name="sp-odd")
    jp, jmel, p, mel = _inputs(jcfg)
    with pytest.raises(ValueError, match="T 30"):
        # T = 30 frames, sp = 8
        encode_seq_parallel(p, mel, tcfg, _sp(8))
    with pytest.raises(ValueError):
        jsp.encode_seq_parallel(jp, jmel, jcfg, jsp.make_sp_mesh(sp=8))


# ---------------------------------------------------------------------------
# the port's own: meshes, placement, sp gradients, errors in a rank
# ---------------------------------------------------------------------------

def test_pp_and_sp_meshes():
    """``make_pp_mesh`` is a (dp, pp) grid and ``make_sp_mesh`` one axis;
    a device count that is not dp * pp (sp) raises; a list may name one
    device more than once; by default the meshes take every card."""
    from nobs_whisper_torch.parallel.pipeline import make_pp_mesh
    from nobs_whisper_torch.parallel.seqparallel import make_sp_mesh
    mesh = make_pp_mesh(pp=2, dp=3, device="cpu")
    assert mesh.shape == {"dp": 3, "pp": 2}
    assert len(mesh.devices) == 3 and len(mesh.devices[0]) == 2
    with pytest.raises(ValueError, match="device count"):
        make_pp_mesh(pp=3, dp=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="device count"):
        make_sp_mesh(4, devices=["cpu"] * 3)
    two = make_pp_mesh(pp=2, devices=["cpu", "cpu"])
    assert two.devices == ((torch.device("cpu"),) * 2,)
    assert make_sp_mesh(2, devices=["cpu", "cpu"]).shape == {"sp": 2}
    if not torch.cuda.is_available():
        for make in (lambda: make_pp_mesh(pp=2), lambda: make_sp_mesh(2)):
            with pytest.raises(RuntimeError, match="cuda"):
                make()


def test_blocks_shard_put_is_reused(monkeypatch):
    """``blocks_shard_put`` places each stage's L/pp layers once; a placed
    stack on the same mesh is reused as it is, and gives the same result;
    one placed on another mesh is refused."""
    from nobs_whisper_torch.parallel import pipeline as pl
    from nobs_whisper_torch.models.whisper import _gelu
    jcfg, tcfg = _cfgs(layers=4)
    _, _, p, _ = _inputs(jcfg)
    mesh = _pp(2, 2)
    staged = pl.blocks_shard_put(p["encoder"]["blocks"], mesh)
    assert [len(row) for row in staged.stages] == [2, 2]
    assert staged.stages[1][1]["q_w"].shape[0] == 2
    torch.testing.assert_close(staged.stages[0][1]["fc1_w"],
                               p["encoder"]["blocks"]["fc1_w"][2:4])
    x = torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(3))
    want = pl.pipeline_blocks(p["encoder"]["blocks"], x, mesh, 4, _gelu)
    calls = []
    real = pl.blocks_shard_put
    monkeypatch.setattr(pl, "blocks_shard_put",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = pl.pipeline_blocks(staged, x, mesh, 4, _gelu)
    assert not calls
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="another mesh"):
        pl.pipeline_blocks(staged, x, _pp(4, 1), 4, _gelu)
    pl.pipeline_blocks(p["encoder"]["blocks"], x, _pp(4, 1), 4, _gelu)
    assert calls == [1]


def test_sp_grad_wrt_input_and_params():
    """sp's k/v all-gathers are differentiable exchanges: one
    ``backward()`` from the calling thread gives the single-device
    gradients wrt the mel and the replicated weights (summed over the
    ranks' copies), within the reference's 1e-3."""
    from nobs_whisper_torch.models.training import trainable_params
    from nobs_whisper_torch.models.whisper import _encode
    from nobs_whisper_torch.parallel.seqparallel import encode_seq_parallel
    from nobs_whisper_torch.parallel.tp import plain_ops
    jcfg, tcfg = _cfgs(layers=2)
    _, _, p, mel = _inputs(jcfg, batch=2, seed=4)
    a, b = (trainable_params(p, device="cpu") for _ in range(2))
    xa, xb = (mel.clone().requires_grad_(True) for _ in range(2))
    (encode_seq_parallel(a, xa, tcfg, _sp(4)) ** 2).sum().backward()
    with plain_ops():
        (_encode(b, xb, tcfg, torch.float32) ** 2).sum().backward()
    _close(xa.grad, xb.grad, tol=1e-3)
    for name in ("k_w", "v_b", "q_w", "fc2_w", "ln1_g"):
        _close(a["encoder"]["blocks"][name].grad,
               b["encoder"]["blocks"][name].grad, tol=1e-3)


def test_sp_rank_error_is_raised():
    """A rank that raises breaks its peers' barrier: the call raises the
    rank's own error, not a broken barrier, and no thread is left
    waiting."""
    import threading

    from nobs_whisper_torch.parallel import seqparallel as spm
    jcfg, tcfg = _cfgs(layers=2)
    _, _, p, mel = _inputs(jcfg, batch=2)
    real = spm._plain_block

    def failing(x, prm, n_head, gelu, kv_map=None):
        if threading.current_thread().name == "nwt-sp-2":
            raise KeyError("rank 2")
        return real(x, prm, n_head, gelu, kv_map)

    spm._plain_block = failing
    try:
        with pytest.raises(KeyError, match="rank 2"):
            spm.encode_seq_parallel(p, mel, tcfg, _sp(4))
    finally:
        spm._plain_block = real
    assert not [t for t in threading.enumerate()
                if t.name.startswith("nwt-sp-")]
