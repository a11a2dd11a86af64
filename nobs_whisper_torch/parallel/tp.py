"""Tensor parallelism over the ``tp`` axis of a mesh, in Megatron form.

The JAX package gets its tp path from GSPMD: the parameters carry
``parallel/mesh.py::param_pspecs`` shardings and XLA derives the
collectives. This module is the port's counterpart. Each tp rank of a
group runs the ordinary single-device forward (``models/whisper.py``) in
a host thread of its own, on its slices of the weights
(``parallel/mesh.py::shard_params``): q/k/v and fc1 split on their output
features (heads, FFN columns), o and fc2 on their input features, the
decoder's ``tok_emb`` (and ``tok_emb_q``) over the vocabulary. The model
asks :func:`current` at the few places where a rank needs its peers:

* after each o / xo / fc2 projection (a partial sum over the rank's input
  features), one all-reduce, in rank order, before the bias is added once;
* before ``dense_int8_dynamic`` quantizes such a split input, the row
  absmax taken across the ranks (:func:`row_dense_int8_dynamic`): the
  reference takes one row scale over the whole contraction axis
  (``ops/quant.py:128``), and per-rank scales would be another function;
* the token embedding (each rank holds a slice of the rows; the lookup is
  an all-reduce of the rows each rank has) and the logits (gathered over
  the vocabulary before the logit rules run).

Every rank then holds the same bits, so the ranks' decode loops take the
same steps and exit together.

Kernels stay off under tp, as in the reference: its kernel gates need one
device or a shard body (reference ``models/whisper.py:261-285``), so GSPMD
runs the plain int8 path, and the port's tp forward runs the plain torch
path on each rank. That is the reference's function, not a fallback. The
same context, at size 1, turns the kernels off on a dp mesh with
``NWT_NO_SPMD`` (the reference's pure-GSPMD dp path), and for training
(:func:`plain_ops`).

The exchanges are differentiable: a peer's tensor comes over with
``.to()`` and the sums and gathers are out-of-place torch ops, so autograd
records rank r's output as a function of every rank's input. The dp x tp
train step (``models/training.py``) runs its forward through them and
takes one ``backward()`` from the calling thread; no collective runs
inside a backward.

The collectives are exchanges through host memory slots under a barrier:
each rank posts its tensor, and every rank copies the others' to its own
device and combines them in rank order. A rank that raises breaks the
barrier, so its peers raise too instead of waiting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Sequence

import torch

_local = threading.local()


class TPGroup:
    """The tp ranks of one dp group: ``devices[r]`` is rank r's device."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self._slots: List[Optional[torch.Tensor]] = [None] * self.size
        self._barrier = threading.Barrier(self.size)

    def abort(self):
        self._barrier.abort()

    def _exchange(self, rank: int, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order, on ``t``'s device."""
        self._slots[rank] = t
        self._barrier.wait()
        parts = [s if i == rank else s.to(t.device)
                 for i, s in enumerate(self._slots)]
        self._barrier.wait()    # every rank holds its copies
        return parts

    def all_reduce_sum(self, rank: int, t: torch.Tensor,
                       acc_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
        """Sum over the ranks in rank order, accumulated in ``acc_dtype``
        (default ``t``'s), returned in ``t``'s dtype."""
        acc_dtype = acc_dtype or t.dtype
        parts = self._exchange(rank, t)
        out = parts[0].to(acc_dtype)
        for p in parts[1:]:
            out = out + p.to(acc_dtype)
        return out.to(t.dtype)

    def all_reduce_max(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(rank, t)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def all_gather(self, rank: int, t: torch.Tensor, dim: int
                   ) -> torch.Tensor:
        return torch.cat(self._exchange(rank, t), dim=dim)


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """What a shard body runs under: its tp group and rank (group None at
    tp == 1) and whether the kernels are off (``plain``: tp > 1, or a dp
    mesh under ``NWT_NO_SPMD``)."""

    group: Optional[TPGroup]
    rank: int = 0
    plain: bool = False
    # the first vocabulary row of this rank's slice of tok_emb
    vocab_lo: int = 0

    @property
    def size(self) -> int:
        return 1 if self.group is None else self.group.size


def current() -> Optional[ShardContext]:
    """The calling thread's shard context, or None off a mesh."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def shard_context(ctx: Optional[ShardContext]):
    prev = current()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def kernels_off() -> bool:
    ctx = current()
    return ctx is not None and ctx.plain


def plain_ops():
    """A context in which every kernel gate is off and the model runs the
    plain torch ops: the calling thread's shard context with ``plain``
    set, or a plain context of its own off a mesh. Training enters it
    (``models/training.py``): autograd differentiates torch ops, not the
    hand-written kernels (``ops/_build.py::no_autograd``)."""
    ctx = current()
    if ctx is None:
        return shard_context(ShardContext(None, plain=True))
    if ctx.plain:
        return contextlib.nullcontext(ctx)
    return shard_context(dataclasses.replace(ctx, plain=True))


def tp_size() -> int:
    ctx = current()
    return 1 if ctx is None else ctx.size


def is_lead() -> bool:
    """True off a mesh and on tp rank 0: the rank that counts a forward."""
    ctx = current()
    return ctx is None or ctx.rank == 0


def local_heads(n_head: int) -> int:
    size = tp_size()
    if n_head % size:
        raise ValueError(f"{n_head} heads do not split over tp={size}")
    return n_head // size


def reduce_partial(y: torch.Tensor) -> torch.Tensor:
    """All-reduce of a row-parallel product's partial sums (identity off
    tp). Summed in f32 (f64 for f64) and rounded once to ``y``'s dtype."""
    ctx = current()
    if ctx is None or ctx.group is None:
        return y
    acc = torch.float64 if y.dtype == torch.float64 else torch.float32
    return ctx.group.all_reduce_sum(ctx.rank, y, acc)


def row_dense(x: torch.Tensor, w, b, dense) -> torch.Tensor:
    """``dense(x, w) + b`` for a weight split on its input features:
    ``dense`` gives the rank's partial product, the ranks sum them, and the
    bias is added once, after."""
    y = reduce_partial(dense(x, w))
    return y if b is None else y + b


def row_dense_int8_dynamic(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """``ops/quant.py::dense_int8_dynamic`` for an input split over tp on
    its last axis: the row absmax is taken across the ranks before the
    rows are quantized, the integer partial sums are added exactly (f64
    holds every sum of int8 products of a Whisper width), then scaled as
    the unsharded op scales them. Equal to the unsharded op bit for bit."""
    from ..ops.quant import int8_matmul_exact
    ctx = current()
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    if ctx is not None and ctx.group is not None:
        amax = ctx.group.all_reduce_max(ctx.rank, amax)
    s_x = torch.clamp(amax / 127.0, min=1e-8)
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    part = int8_matmul_exact(x_q, w["q"]) if ctx is None or \
        ctx.group is None else (x_q.to(torch.float64)
                                @ w["q"].to(torch.float64))
    y = reduce_partial(part).to(torch.float32) * s_x * w["s"]
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def embed(tok_emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``tok_emb[tokens]`` for a table split over the vocabulary: each
    rank looks up the rows it holds, zero elsewhere, and the ranks sum
    (one nonzero term a row: exact)."""
    ctx = current()
    if ctx is None or ctx.group is None:
        return tok_emb[tokens]
    ids = tokens - ctx.vocab_lo
    mine = (ids >= 0) & (ids < tok_emb.shape[0])
    rows = tok_emb[torch.clamp(ids, 0, tok_emb.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return ctx.group.all_reduce_sum(ctx.rank, rows)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Logits over the rank's vocabulary slice -> over the whole
    vocabulary (identity off tp)."""
    ctx = current()
    if ctx is None or ctx.group is None:
        return logits
    return ctx.group.all_gather(ctx.rank, logits, dim=-1)
