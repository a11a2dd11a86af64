"""The port's dp x tp train step (``models/training.py::train_step`` with
a mesh) on the CPU: a twin of the reference's
``tests/test_parallel.py::test_sharded_train_step_runs_and_improves`` at
dp=4 x tp=2, f32, lr 1e-3; the mesh step's loss and master gradients
against one device's; three mesh steps against the JAX package's sharded
train step on its 8 virtual CPU devices; the global masked mean when the
masks differ between dp shards; the divisibility refusals; and the
``--mesh`` parse, which takes DPxTP only. The port's CPU stand-in for the
8 devices is the CPU named dp * tp times."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(name="par-test", heads=4):
    from nobs_whisper_torch.core.config import WhisperConfig as TC
    from nobs_whisper_tpu.core.config import WhisperConfig as JC
    kw = dict(name=name, n_mels=80, n_vocab=1024, n_audio_ctx=32,
              n_audio_state=128, n_audio_head=heads, n_audio_layer=2,
              n_text_ctx=32, n_text_state=128, n_text_head=heads,
              n_text_layer=2, n_langs=4, eot_id=1000,
              force_multilingual=True)
    return JC(**kw), TC(**kw)


def _params(jcfg, seed=0):
    from nobs_whisper_torch.models.training import trainable_params
    from nobs_whisper_torch.models.whisper import params_from_jax
    from nobs_whisper_tpu.models.whisper import init_params
    jp = init_params(jax.random.PRNGKey(seed), jcfg)
    host = params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, lambda: trainable_params(host, device="cpu")


def _batch(seed=0, b=8, s=16, mask=None):
    rng = np.random.RandomState(seed)
    mel = rng.randn(b, 80, 64).astype(np.float32)
    tokens = rng.randint(0, 1000, size=(b, s)).astype(np.int32)
    m = np.ones((b, s), np.float32) if mask is None else mask
    return mel, tokens, m


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _mesh(dp, tp):
    from nobs_whisper_torch.parallel.mesh import make_mesh
    return make_mesh(dp=dp, tp=tp, device="cpu")


def _leaf_items(tree):
    from nobs_whisper_torch.core.native_ckpt import flatten
    return flatten(tree).items()


def test_sharded_train_step_runs_and_improves():
    """The reference's case on the port: dp=4 x tp=2, f32, lr 1e-3, three
    steps on one batch; the loss is finite and below the first."""
    from nobs_whisper_torch.models.training import (loss_fn, make_optimizer,
                                                    train_step)
    jcfg, tcfg = _cfgs()
    _, fresh = _params(jcfg)
    params = fresh()
    mesh = _mesh(4, 2)
    optimizer = make_optimizer(params, lr=1e-3)
    mel, tokens, mask = _t(*_batch())
    with torch.no_grad():
        loss0 = float(loss_fn(params, mel, tokens, mask, tcfg,
                              compute_dtype=torch.float32))
    for _ in range(3):
        loss = train_step(params, optimizer, mel, tokens, mask, tcfg,
                          compute_dtype=torch.float32, mesh=mesh)
    assert np.isfinite(float(loss))
    assert float(loss) < loss0  # same batch -> loss must drop


@pytest.mark.parametrize("dp,tp", [(4, 2), (1, 2), (2, 1)])
def test_mesh_loss_and_grads_match_one_device(dp, tp):
    """The mesh step's loss equals one device's within 1e-5 relative, and
    every master leaf's gradient within atol 1e-6 + rtol 1e-5: the tp
    exchanges and the shards' slices are differentiable, a replicated
    leaf's gradient sums over its copies, a split leaf's slices come back
    into their places. The only difference is the f32 order of the tp
    partial sums and of the gradient sums."""
    from nobs_whisper_torch.models.training import (_mesh_loss, loss_fn)
    jcfg, tcfg = _cfgs()
    _, fresh = _params(jcfg)
    one, sharded = fresh(), fresh()
    mel, tokens, m = _batch(seed=1)
    m[:, 11:] = 0
    l1 = loss_fn(one, *_t(mel, tokens, m), tcfg, torch.float32)
    l1.backward()
    lm = _mesh_loss(sharded, *_t(mel, tokens, m), tcfg, torch.float32,
                    _mesh(dp, tp))
    lm.backward()
    assert lm.item() == pytest.approx(l1.item(), rel=1e-5)
    want = dict(_leaf_items(one))
    for name, t in _leaf_items(sharded):
        assert t.grad is not None, f"{name}: no gradient"
        np.testing.assert_allclose(t.grad.numpy(), want[name].grad.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_mesh_steps_match_jax_sharded_steps():
    """Three dp=4 x tp=2 steps (f32, lr 1e-3) give the JAX package's
    sharded ``train_step``'s losses within 1e-4 relative (its params and
    batch placed with ``shard_params`` / ``batch_sharding`` on the 8
    virtual devices; GSPMD derives its collectives)."""
    from nobs_whisper_torch.models.training import make_optimizer, train_step
    from nobs_whisper_tpu.models import training as jt
    from nobs_whisper_tpu.parallel import mesh as jm
    jcfg, tcfg = _cfgs()
    jp, fresh = _params(jcfg)
    params = fresh()
    mel, tokens, m = _batch(seed=2)
    m[3:, 12:] = 0
    jmesh = jm.make_mesh(dp=4, tp=2)
    jparams = jm.shard_params(jp, jmesh)
    bsh = jm.batch_sharding(jmesh)
    jb = [jax.device_put(a, bsh) for a in (mel, tokens, m)]
    tx = jt.make_optimizer(lr=1e-3)
    state = tx.init(jparams)
    opt = make_optimizer(params, lr=1e-3)
    mesh = _mesh(4, 2)
    want, got = [], []
    for _ in range(3):
        jparams, state, jl = jt.train_step(jparams, state, *jb, jcfg, tx,
                                           compute_dtype=jnp.float32)
        want.append(float(jl))
        got.append(float(train_step(params, opt, *_t(mel, tokens, m), tcfg,
                                    torch.float32, mesh=mesh)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_global_masked_mean_over_shards():
    """Masks that differ between the dp shards: the mesh loss is the
    reference's global masked mean, sum(nll * mask) / max(sum(mask), 1)
    over the whole batch, equal to one device's; the mean of the shards'
    own masked means is another number. A shard with no loss position
    adds 0 to both sums."""
    from nobs_whisper_torch.models.training import _nll_parts, loss_fn, \
        _mesh_loss
    jcfg, tcfg = _cfgs()
    _, fresh = _params(jcfg)
    params = fresh()
    m = np.ones((8, 16), np.float32)
    m[0:2, 3:] = 0          # shard 0: few positions
    m[4:6] = 0              # shard 2: none
    m[6:8, 14:] = 0
    mel, tokens, m = _batch(seed=3, mask=m)
    with torch.no_grad():
        one = float(loss_fn(params, *_t(mel, tokens, m), tcfg,
                            torch.float32))
        mesh = float(_mesh_loss(params, *_t(mel, tokens, m), tcfg,
                                torch.float32, _mesh(4, 2)))
        per_shard = []
        for i in range(4):
            rows = slice(2 * i, 2 * i + 2)
            num, den = _nll_parts(params, *_t(mel[rows], tokens[rows],
                                              m[rows]), tcfg, torch.float32)
            per_shard.append(float(num / max(float(den), 1.0)))
    assert mesh == pytest.approx(one, rel=1e-5)
    assert abs(np.mean(per_shard) - one) > 1e-2 * one


def test_mesh_train_step_refusals():
    """The reference's divisibility rules: the batch divides by dp, heads
    (and FFN columns) by tp; int8 params are refused at entry. A tp rank
    that raises aborts its group's barrier, and the step raises the
    rank's error, not a broken barrier."""
    from nobs_whisper_torch.models.training import make_optimizer, train_step
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    jcfg, tcfg = _cfgs()
    _, fresh = _params(jcfg)
    params = fresh()
    opt = make_optimizer(params)
    mel, tokens, m = _t(*_batch(b=6))
    with pytest.raises(ValueError, match="dp=4"):
        train_step(params, opt, mel, tokens, m, tcfg, torch.float32,
                   mesh=_mesh(4, 2))
    jcfg3, tcfg3 = _cfgs(name="heads-3", heads=2)
    _, fresh3 = _params(jcfg3)
    p3 = fresh3()
    with pytest.raises(ValueError, match="tp=4"):
        train_step(p3, make_optimizer(p3), mel[:4], tokens[:4], m[:4],
                   tcfg3, torch.float32, mesh=_mesh(1, 4))
    with torch.no_grad():
        q = quantize_decoder_params(params)
    with pytest.raises(ValueError, match="unquantized"):
        train_step(q, opt, mel, tokens, m, tcfg, torch.float32,
                   mesh=_mesh(2, 1))


def test_cli_mesh_takes_dp_x_tp_only():
    """``serve --mesh`` parses DPxTP only, as the reference's does
    (``partition("x")``, so a third factor fails its ``int``): a third
    factor takes the refusal of a malformed spec. pp and sp serve
    nothing in either package."""
    from nobs_whisper_torch.cli import _parse_mesh
    for spec in ("2x2x2", "1x2x2"):
        with pytest.raises(SystemExit, match="expected DPxTP"):
            _parse_mesh(spec, "cpu")
