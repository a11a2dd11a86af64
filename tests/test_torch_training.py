"""The port's training step (``nobs_whisper_torch/models/training.py``) on
one CPU device, held to the JAX package's ``models/training.py`` on the
same seeded weights and batch: the loss at f32 and bf16 (masks with zeros
and all zero), every leaf's gradient at f32, one AdamW update against
``optax.adamw``, three train steps, the refusal of int8 params, and the
guard that keeps hand-written kernels out of a training forward
(``ops/_build.py::no_autograd``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(heads=4, name="train-test"):
    """The JAX package's tiny config and the port's equal one."""
    from nobs_whisper_torch.core.config import WhisperConfig as TC
    from nobs_whisper_tpu.core.config import WhisperConfig as JC
    kw = dict(name=name, n_mels=80, n_vocab=1024, n_audio_ctx=32,
              n_audio_state=128, n_audio_head=heads, n_audio_layer=2,
              n_text_ctx=32, n_text_state=128, n_text_head=heads,
              n_text_layer=2, n_langs=4, eot_id=1000,
              force_multilingual=True)
    return JC(**kw), TC(**kw)


def _params(jcfg, seed=0, dtype=jnp.float32):
    """The JAX package's params and the port's trainable copy of them."""
    from nobs_whisper_torch.models.training import trainable_params
    from nobs_whisper_torch.models.whisper import params_from_jax
    from nobs_whisper_tpu.models.whisper import init_params
    jp = jax.tree.map(lambda a: a.astype(dtype),
                      init_params(jax.random.PRNGKey(seed), jcfg))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    host = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jp, trainable_params(params_from_jax(host, dtype=tdt),
                                device="cpu")


def _batch(mask="zeros", b=4, s=16, seed=0):
    rng = np.random.RandomState(seed)
    mel = rng.randn(b, 80, 64).astype(np.float32)
    tokens = rng.randint(0, 1000, size=(b, s)).astype(np.int32)
    m = np.ones((b, s), np.float32)
    if mask == "zeros":          # padded tails, one row with no loss
        m[:, s - 5:] = 0
        m[1] = 0
        m[2, :4] = 0
    elif mask == "all-zero":
        m[:] = 0
    return mel, tokens, m


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _leaf_items(tree):
    from nobs_whisper_torch.core.native_ckpt import flatten
    return flatten(tree).items()


# ---------------------------------------------------------------------------
# the loss and its gradient against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["ones", "zeros", "all-zero"])
def test_loss_matches_jax_f32(mask):
    """f32: the port's loss within 1e-5 relative of the JAX package's; an
    all-zero mask gives 0 in both (the denominator is at least 1)."""
    from nobs_whisper_torch.models.training import loss_fn
    from nobs_whisper_tpu.models import training as jt
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    mel, tokens, m = _batch(mask)
    want = float(jt.loss_fn(jp, mel, tokens, m, jcfg, jnp.float32))
    got = loss_fn(tp, *_t(mel, tokens, m), tcfg, torch.float32).detach()
    assert got.dtype == torch.float32 and got.dim() == 0
    if mask == "all-zero":
        assert want == 0.0 and float(got) == 0.0
    else:
        assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("mask", ["ones", "zeros"])
def test_loss_matches_jax_bf16(mask):
    """bf16 params at bf16 compute (the reference's bf16 training needs
    bf16 params: its scan carry refuses an f32 result from f32 weights):
    within 2e-3 relative. Both round the same ops to bf16 (exact-erf gelu
    in the decoder, tanh-gelu in the encoder, f32 LayerNorm, softmax and
    logits); XLA's compiled bf16 chains may skip intermediate roundings,
    which moves the loss by a few bf16 steps of its inputs, not more."""
    from nobs_whisper_torch.models.training import loss_fn
    from nobs_whisper_tpu.models import training as jt
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, dtype=jnp.bfloat16)
    mel, tokens, m = _batch(mask, seed=1)
    want = float(jt.loss_fn(jp, mel, tokens, m, jcfg, jnp.bfloat16))
    got = loss_fn(tp, *_t(mel, tokens, m), tcfg).item()   # default bf16
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=2e-3)


def test_grads_match_jax_f32():
    """f32: the gradient wrt every leaf (the encoder's ``pos``, every
    LayerNorm and bias included) within atol 1e-5 + rtol 1e-4 of
    ``jax.grad(loss_fn)``'s, leaf by leaf."""
    from nobs_whisper_torch.models.training import loss_fn
    from nobs_whisper_tpu.models import training as jt
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    mel, tokens, m = _batch("zeros", seed=2)
    jl, jg = jax.value_and_grad(jt.loss_fn)(jp, mel, tokens, m, jcfg,
                                            jnp.float32)
    loss = loss_fn(tp, *_t(mel, tokens, m), tcfg, torch.float32)
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    want = dict(_leaf_items(jax.tree.map(np.asarray, jg)))
    got = dict(_leaf_items(tp))
    assert want.keys() == got.keys()
    for name, g in want.items():
        assert got[name].grad is not None, f"{name}: no gradient"
        np.testing.assert_allclose(got[name].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_adamw_step_matches_optax():
    """One ``torch.optim.AdamW`` step from the same params and gradients
    as one ``optax.adamw`` update (lr 1e-3, weight decay 0.01): within
    1e-7 absolute plus two f32 steps of the value (2.5e-7 relative). The
    update is of order lr; torch decays the parameter before the Adam
    step and optax adds the decay to the update, so the two round
    differently, by an f32 step of the parameter (1.2e-7 at a LayerNorm
    gain of 1)."""
    import optax

    from nobs_whisper_torch.models.training import make_optimizer
    from nobs_whisper_tpu.models import training as jt
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    mel, tokens, m = _batch("ones", seed=3)
    jg = jax.grad(jt.loss_fn)(jp, mel, tokens, m, jcfg, jnp.float32)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    updates, _ = tx.update(jg, tx.init(jp), jp)
    want = dict(_leaf_items(jax.tree.map(
        np.asarray, optax.apply_updates(jp, updates))))
    opt = make_optimizer(tp, lr=1e-3, weight_decay=0.01)
    got = dict(_leaf_items(tp))
    grads = dict(_leaf_items(jax.tree.map(np.asarray, jg)))
    assert sum(len(g["params"]) for g in opt.param_groups) == len(got)
    for name, t in got.items():
        t.grad = torch.from_numpy(grads[name].copy())
    opt.step()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, atol=1e-7,
                                   rtol=2.5e-7, err_msg=name)
    # the default is the reference's lr 1e-5, weight decay 0.01
    d = make_optimizer(tp).param_groups[0]
    assert (d["lr"], d["weight_decay"], d["betas"], d["eps"]) == (
        1e-5, 0.01, (0.9, 0.999), 1e-8)


def test_three_train_steps_match_jax_and_fall():
    """Three ``train_step``s on one batch at f32, lr 1e-3: each step's loss
    (before its update) within 1e-4 relative of the JAX package's
    ``train_step``, and the loss falls. Adam turns gradients of order 1e-9
    into updates of order lr, so f32 noise in them moves later steps
    slightly more than the first."""
    from nobs_whisper_torch.models.training import make_optimizer, train_step
    from nobs_whisper_tpu.models import training as jt
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    mel, tokens, m = _batch("zeros", seed=4)
    tx = jt.make_optimizer(lr=1e-3)
    state = tx.init(jp)
    opt = make_optimizer(tp, lr=1e-3)
    want, got = [], []
    for _ in range(3):
        jp, state, jl = jt.train_step(jp, state, mel, tokens, m, jcfg, tx,
                                      compute_dtype=jnp.float32)
        want.append(float(jl))
        got.append(float(train_step(tp, opt, *_t(mel, tokens, m), tcfg,
                                    torch.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[1] < got[0]


def test_int8_params_refused():
    """int8 params raise the port's ValueError at entry (loss, step and
    the trainable copy). The JAX package's own training forward meets an
    int8 decoder weight with ``@`` and raises a TypeError of its own."""
    from nobs_whisper_torch.models.training import (loss_fn, make_optimizer,
                                                    trainable_params,
                                                    train_step)
    from nobs_whisper_torch.models.whisper import params_from_jax
    from nobs_whisper_torch.ops.quant import (quantize_decoder_params,
                                              quantize_encoder_params)
    from nobs_whisper_tpu.models import training as jt
    from nobs_whisper_tpu.ops import quant as jq
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    mel, tokens, m = _batch("ones")
    with pytest.raises(TypeError):
        jt.loss_fn(jq.quantize_encoder_params(jq.quantize_decoder_params(
            jp)), mel, tokens, m, jcfg, jnp.float32)
    host = params_from_jax(jax.tree.map(np.asarray, jp))
    for q in (quantize_encoder_params(host), quantize_decoder_params(host)):
        with pytest.raises(ValueError, match="unquantized"):
            loss_fn(q, *_t(mel, tokens, m), tcfg, torch.float32)
        with pytest.raises(ValueError, match="unquantized"):
            train_step(q, make_optimizer(tp), *_t(mel, tokens, m), tcfg,
                       torch.float32)
        with pytest.raises(ValueError, match="unquantized"):
            trainable_params(q, device="cpu")


# ---------------------------------------------------------------------------
# the guard and the differentiable encode
# ---------------------------------------------------------------------------

def _wrappers():
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import conv_stem as cs
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import fused_qkv as fq
    from nobs_whisper_torch.ops import mel_pallas as mp
    from nobs_whisper_torch.ops import quant as qt
    return {"K1": (ea.encoder_attention_fused_qkv, 11),
            "K2": (fm.encoder_mlp_int8_resident, 7),
            "K3": (ea.encoder_attention_btd, 6),
            "K4": (ap.cross_attention_decode_bf16, 3),
            "K5": (ap.cross_attention_decode_q8, 3),
            "K6": (qt.q8_matmul, 2),
            "K6-bf16": (qt.q8_matmul_bf16, 2),
            "K7": (fm.fused_mlp_q8, 7),
            "K8": (fm.encoder_mlp_int8, 7),
            "K9": (ea.encoder_attention, 5),
            "K10": (fq.encoder_qkv_int8, 8),
            "K11": (fq.residual_o_int8, 4),
            "K12": (fl.encoder_layer_fused, 19),
            "K13": (cs.encoder_stem_fused, 7),
            "K14": (mp.log10_mel_pallas, 1)}


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
           "K11", "K12", "K13", "K14", "K6-bf16")


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_wrapper_refuses_grad_inputs(kernel):
    """Every kernel wrapper raises RuntimeError when grad mode is on and
    its first input requires grad, before anything that needs a card (its
    CPU plain version stands in for the kernel and is refused alike);
    under ``no_grad`` and ``inference_mode`` the check passes and the
    wrapper goes on (here to its own argument checks)."""
    fn, n_args = _wrappers()[kernel]
    x = torch.zeros(2, 2, requires_grad=True)
    args = [x] + [torch.zeros(1)] * (n_args - 1)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            try:
                fn(*args)
            except RuntimeError as e:
                assert "requires grad" not in str(e), kernel
            except (ValueError, TypeError, AssertionError, IndexError,
                    KeyError):
                pass


def test_guard_sees_qtensor_parts_and_grad_mode():
    """The check looks inside QTensor dicts and reads grad mode: a weight
    that requires grad under grad mode raises; no input that requires
    grad, or grad mode off, passes."""
    from nobs_whisper_torch.ops._build import no_autograd
    w = {"q": torch.zeros(2, 2, dtype=torch.int8),
         "s": torch.ones(1, 2, requires_grad=True)}
    with pytest.raises(RuntimeError, match="K6"):
        no_autograd("K6", torch.zeros(1, 2), w)
    no_autograd("K6", torch.zeros(1, 2), {"q": w["q"], "s": torch.ones(2)})
    with torch.no_grad():
        no_autograd("K6", torch.zeros(1, 2), w)


def test_training_forward_reaches_no_kernel(monkeypatch):
    """At bf16 on a model whose heads pair (dh 64: the serving gates would
    take K3 there, and K2 on int8), the training forward calls no kernel
    wrapper's plain version: it runs inside ``plain_ops``. With that
    context taken away, the first wrapper it reaches raises the guard's
    RuntimeError instead of quietly returning an output without a
    gradient (the card's ``[train]`` phase checks the same)."""
    import contextlib

    from nobs_whisper_torch.models import training as tr
    from nobs_whisper_torch.utils.testing import KernelSpies
    jcfg, tcfg = _cfgs(heads=2, name="train-pairs")
    _, tp = _params(jcfg, dtype=jnp.bfloat16)
    mel, tokens, m = _batch("ones", seed=5)
    spies = KernelSpies(monkeypatch.setattr, kernels=KernelSpies.ENCODER
                        + ("K4", "K5", "K6", "K7", "K14"))
    loss = tr.loss_fn(tp, *_t(mel, tokens, m), tcfg)
    loss.backward()
    assert not any(spies.calls.values()), spies.calls
    assert tp["encoder"]["blocks"]["q_w"].grad is not None
    monkeypatch.setattr(tr._tp, "plain_ops", contextlib.nullcontext)
    with pytest.raises(RuntimeError, match="K3: a hand-written kernel"):
        tr.loss_fn(tp, *_t(mel, tokens, m), tcfg)


def test_encoder_output_joins_the_graph(monkeypatch):
    """The encoder states that ``loss_fn`` hands the decoder carry a
    ``grad_fn``: an encode under ``inference_mode`` (the public
    ``encode``) would give the encoder no gradient."""
    from nobs_whisper_torch.models import training as tr
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    seen = []
    real = tr._decoder_train_forward

    def spy(params, tokens, xa, cfg, compute_dtype):
        seen.append(xa)
        return real(params, tokens, xa, cfg, compute_dtype)

    monkeypatch.setattr(tr, "_decoder_train_forward", spy)
    mel, tokens, m = _batch("ones")
    tr.loss_fn(tp, *_t(mel, tokens, m), tcfg, torch.float32).backward()
    (xa,) = seen
    assert xa.grad_fn is not None and not xa.is_inference()
    enc = tp["encoder"]
    for name in ("conv1_w", "pos", "ln_post_g"):
        assert enc[name].grad is not None and enc[name].grad.abs().sum() > 0
    assert tp["decoder"]["pos"].grad is not None


def test_trainable_params_from_an_inference_tree():
    """An engine's tree is made under ``inference_mode``; the trainable
    copy is plain tensors that take gradients, leaves the engine's tensors
    as they were, and keeps the values (and the dtype unless asked)."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.models.training import trainable_params
    eng = WhisperEngine.from_random("tiny", dtype=torch.float32,
                                    device="cpu")
    src = dict(_leaf_items(eng.params))
    tp = trainable_params(eng.params, device="cpu")
    for name, t in _leaf_items(tp):
        assert t.requires_grad and t.is_leaf and not t.is_inference(), name
        assert torch.equal(t.detach(), src[name]), name
        assert not src[name].requires_grad
    bf = trainable_params(eng.params, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaf_items(bf))
    with torch.inference_mode():
        again = trainable_params(eng.params, device="cpu")
    assert not any(t.is_inference() for _, t in _leaf_items(again))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            trainable_params(eng.params)      # the card by default


def test_plain_ops_context():
    """``plain_ops`` turns every kernel gate off in its thread and puts the
    previous context back after; inside a plain shard it changes
    nothing."""
    from nobs_whisper_torch.parallel import tp as T
    assert T.current() is None and not T.kernels_off()
    with T.plain_ops() as ctx:
        assert T.kernels_off() and ctx.group is None and ctx.size == 1
    assert T.current() is None
    shard = T.ShardContext(None, rank=0, plain=False, vocab_lo=7)
    with T.shard_context(shard):
        with T.plain_ops():
            assert T.kernels_off() and T.current().vocab_lo == 7
        assert T.current() is shard
        plain = T.ShardContext(None, plain=True)
        with T.shard_context(plain), T.plain_ops():
            assert T.current() is plain
