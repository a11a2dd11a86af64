"""Training / fine-tuning step: teacher-forced cross-entropy (port of
``models/training.py``).

One loss over the serving encoder and a full-sequence causal decoder,
its gradient by autograd, and an AdamW update. The reference takes
``jax.value_and_grad`` and ``optax.adamw``; here ``loss.backward()`` and
``torch.optim.AdamW``. Under a dp x tp mesh the reference lets GSPMD derive
the collectives; here each mesh position runs the forward in a host thread
on its shards of one master tree (``parallel/spmd.py::run_on_mesh``), the
tp exchanges are differentiable (``parallel/tp.py``), and the caller takes
one ``backward()`` of the global loss.

The forward runs the plain torch ops (``parallel/tp.py::plain_ops``), as
the reference's does at f32, on float weights, or on more than one device:
autograd differentiates torch ops, and a hand-written kernel reached with
a trainable input raises (``ops/_build.py::no_autograd``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.config import WhisperConfig
from ..core.device import disable_tf32, resolve_device
from ..core.native_ckpt import flatten, unflatten
from ..parallel import tp as _tp
from ..parallel.pipeline import _require_unquantized
from .whisper import (_attention, _encode, _f32_dot, _gelu, _layer,
                      _layer_norm, _merge_heads, _split_heads)

Params = Dict[str, Any]


def trainable_params(params: Params, device="cuda",
                     dtype: Optional[torch.dtype] = None) -> Params:
    """A trainable copy of a parameter tree (an engine's, ``init_params``',
    ``params_from_jax``'): every leaf a fresh tensor on ``device`` (the card
    unless the caller asks for the CPU), in ``dtype`` (default its own),
    with ``requires_grad=True``. The copy breaks any link to inference
    tensors, which a tree built under ``inference_mode`` holds and which
    can never join an autograd graph. int8 trees raise ValueError."""
    _require_unquantized(params, "training")
    dev = resolve_device(device)
    with torch.inference_mode(False):
        return unflatten({
            k: t.detach().to(device=dev, dtype=dtype or t.dtype,
                             copy=True).requires_grad_(True)
            for k, t in flatten(params).items()})


def _decoder_train_forward(params: Params, tokens: torch.Tensor,
                           xa: torch.Tensor, cfg: WhisperConfig,
                           compute_dtype) -> torch.Tensor:
    """Full-sequence causal decoder forward (no KV cache: the training
    path). tokens: (B, S); returns f32 logits (B, S, V).

    Under tp (``parallel/tp.py``) a rank holds its heads, FFN columns and
    vocabulary rows: the embedding is looked up across the ranks, o, xo and
    fc2 sum their partial products, and the logits are gathered over the
    vocabulary, all through the differentiable exchanges."""
    dec = params["decoder"]
    n_head = _tp.local_heads(cfg.n_text_head)
    b, s = tokens.shape
    x = (_tp.embed(dec["tok_emb"], tokens)
         + dec["pos"][:s]).to(compute_dtype)
    q_idx = torch.arange(s, device=tokens.device)[:, None]
    causal = (torch.arange(s, device=tokens.device)[None, :]
              <= q_idx)[None, None]                              # (1,1,S,S)

    def row(h, w, bias):
        # o, xo, fc2: split over tp on their input features
        return _tp.row_dense(h, w, bias, lambda a, z: a @ z)

    for i in range(cfg.n_text_layer):
        p = _layer(dec["blocks"], i)
        h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
        q = _split_heads(h @ p["q_w"] + p["q_b"], n_head)
        k = _split_heads(h @ p["k_w"], n_head)
        v = _split_heads(h @ p["v_w"] + p["v_b"], n_head)
        a = _merge_heads(_attention(q, k, v, causal))
        x = x + row(a, p["o_w"], p["o_b"])
        h = _layer_norm(x, p["lnx_g"], p["lnx_b"])
        q = _split_heads(h @ p["xq_w"] + p["xq_b"], n_head)
        xk = _split_heads(xa @ p["xk_w"], n_head)
        xv = _split_heads(xa @ p["xv_w"] + p["xv_b"], n_head)
        a = _merge_heads(_attention(q, xk, xv, None))
        x = x + row(a, p["xo_w"], p["xo_b"])
        h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
        h = _gelu(h @ p["fc1_w"] + p["fc1_b"])
        x = x + row(h, p["fc2_w"], p["fc2_b"])
    x = _layer_norm(x, dec["ln_g"], dec["ln_b"])
    return _tp.gather_vocab(_f32_dot(x, dec["tok_emb"].transpose(0, 1)))


def _nll_parts(params: Params, mel: torch.Tensor, tokens: torch.Tensor,
               token_mask: torch.Tensor, cfg: WhisperConfig, compute_dtype):
    """(sum(nll * mask), sum(mask)) of the teacher-forced loss, f32 0-d
    tensors: the two halves of :func:`loss_fn`'s masked mean, kept apart so
    that dp shards can add theirs before the one division."""
    disable_tf32()      # f32 means f32, in the forward and the backward
    with _tp.plain_ops():
        xa = _encode(params, mel, cfg, compute_dtype)
        logits = _decoder_train_forward(params, tokens[:, :-1], xa, cfg,
                                        compute_dtype)
    targets = tokens[:, 1:].long()
    mask = token_mask[:, 1:].to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, targets[..., None], dim=-1)[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def _masked_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp(den, min=1.0)


def loss_fn(params: Params, mel: torch.Tensor, tokens: torch.Tensor,
            token_mask: torch.Tensor, cfg: WhisperConfig,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Teacher-forced NLL. tokens: (B, S) where position i predicts i+1;
    token_mask masks loss positions (padding / prompt). The mean over the
    whole batch: sum(nll * mask) / max(sum(mask), 1), so an all-zero mask
    gives 0.

    The encoder is ``models/whisper.py::_encode`` with grad enabled (the
    public ``encode`` runs under ``inference_mode``, whose tensors never
    join a graph) and every kernel gate off; TF32 stays off. int8 params
    raise ValueError (the reference's forward meets an int8 decoder weight
    with ``@`` and fails with a TypeError of its own)."""
    _require_unquantized(params, "training")
    return _masked_mean(*_nll_parts(params, mel, tokens, token_mask, cfg,
                                    compute_dtype))


def make_optimizer(params: Params, lr: float = 1e-5,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over every floating leaf of the tree, the encoder's sinusoidal
    ``pos``, the LayerNorms and the biases included, as optax's ``adamw``
    (mask None) updates every leaf; its betas (0.9, 0.999) and eps 1e-8
    are torch's defaults. The two round differently: torch decays the
    parameter before the Adam step, optax adds the decay to the update."""
    leaves = [t for t in flatten(params).values() if t.is_floating_point()]
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _mesh_loss(params: Params, mel, tokens, token_mask, cfg, compute_dtype,
               mesh) -> torch.Tensor:
    """The global masked mean over a dp x tp mesh. Each position runs the
    forward on its shards of the master tree, made under grad mode by
    ``shard_params``' differentiable slices; each dp group returns its
    tp rank 0's (numerator, denominator). The numerators and the
    denominators are summed over the groups before the one division: the
    mean of per-shard means is another function whenever the masks differ
    between shards."""
    from ..parallel.mesh import shard_params
    from ..parallel.spmd import run_on_mesh

    def body(p, m, t, k):
        num, den = _nll_parts(p, m, t, k, cfg, compute_dtype)
        return num[None], den[None]

    num, den = run_on_mesh(mesh, shard_params(params, mesh), body,
                           (mel, tokens, token_mask))
    return _masked_mean(num.sum(), den.sum())


def train_step(params: Params, optimizer: torch.optim.Optimizer,
               mel: torch.Tensor, tokens: torch.Tensor,
               token_mask: torch.Tensor, cfg: WhisperConfig,
               compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """One update: the loss, its gradient, the optimizer's step. Returns
    the loss before the update (a detached 0-d tensor).

    ``params`` is a trainable tree (:func:`trainable_params`) and
    ``optimizer`` holds its leaves (:func:`make_optimizer`). The reference
    donates its params and returns new ones; here the leaves are updated in
    place, torch's idiom. With a (dp, tp) ``mesh`` (``parallel/mesh.py``)
    the master tree stays where it is (the mesh's first device is the
    natural place), the batch splits over dp (it must divide), heads and
    FFN columns over tp (they must divide), and the one ``backward()``
    runs from the calling thread, never inside a shard thread."""
    _require_unquantized(params, "training")
    optimizer.zero_grad(set_to_none=True)
    if mesh is None:
        loss = _masked_mean(*_nll_parts(params, mel, tokens, token_mask, cfg,
                                        compute_dtype))
    else:
        loss = _mesh_loss(params, mel, tokens, token_mask, cfg,
                          compute_dtype, mesh)
    loss.backward()
    optimizer.step()
    return loss.detach()
