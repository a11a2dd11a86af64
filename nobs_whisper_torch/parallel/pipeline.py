"""Pipeline parallelism (pp) for the encoder layer stack (port of
``parallel/pipeline.py``).

GPipe over the stacked encoder layers on a (dp, pp) mesh:

- stage s holds L/pp contiguous layers of the stacked (L, ...) tree on
  its device (:func:`blocks_shard_put`, once);
- the batch is split into microbatches; at step t stage s runs microbatch
  t - s, and its output moves to stage s + 1's device with ``.to()``
  (the reference's ``ppermute`` over ICI); the last stage banks each
  finished microbatch, so after a pp - 1 step fill every stage is busy;
- under dp each dp row of stages takes its contiguous slice of every
  microbatch.

The encoder forward makes no host sync, so one host thread enqueues every
stage's work in schedule order and stages on different cards overlap by
themselves. Autograd records the schedule, so gradients wrt the input and
wrt each stage's layers come from ``backward()`` with no hand-written
rule, the property the reference gets from its ``lax.scan``.

As in the reference, pp is a capability axis (a model too large for one
card, fine-tuning across cards), not a serving path: nothing serves
through it, and it runs the plain torch block math on unquantized weights
(:func:`_plain_block`), never a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.config import WhisperConfig
from ..core.device import disable_tf32
from ..core.native_ckpt import flatten
from ..models.whisper import (_attention, _conv1d, _gelu, _gelu_fast, _layer,
                              _layer_norm, _merge_heads, _split_heads)
from .mesh import Mesh, default_devices

Params = Dict[str, Any]


def make_pp_mesh(pp: int, dp: int = 1, devices=None,
                 device="cuda") -> Mesh:
    """(dp, pp) mesh: microbatches flow over 'pp', the batch shards over
    'dp'. With ``devices`` None: every visible card, or the CPU named
    dp * pp times when ``device`` asks for the CPU
    (``mesh.py::default_devices``). Raises ValueError when dp * pp is not
    the number of devices."""
    if devices is None:
        devices = default_devices(dp * pp, device)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp < 1 or pp < 1 or dp * pp != n:
        raise ValueError(f"dp({dp}) * pp({pp}) != device count ({n})")
    return Mesh(tuple(tuple(devices[i * pp:(i + 1) * pp])
                      for i in range(dp)), axis_names=("dp", "pp"))


def _plain_block(x: torch.Tensor, p: Params, n_head: int, gelu,
                 kv_map=None) -> torch.Tensor:
    """One encoder block in the plain path's exact math
    (``models/whisper.py::_encode`` with every gate off: LN -> q/k/v ->
    attention -> o + residual -> LN -> fc1 -> gelu -> fc2 + residual).
    Unquantized weights only.

    ``kv_map`` (optional) is applied to the k/v projections before the
    head split: the one hook sequence parallelism needs (the full
    sequence's k/v while q stays sharded; ``parallel/seqparallel.py``), so
    pp and sp share one copy of the block math. One device keeps its own
    in ``_encode``; the tests hold the two to each other."""
    h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
    q = _split_heads(h @ p["q_w"] + p["q_b"], n_head)
    kf = h @ p["k_w"]
    vf = h @ p["v_w"] + p["v_b"]
    if kv_map is not None:
        kf, vf = kv_map(kf), kv_map(vf)
    k = _split_heads(kf, n_head)
    v = _split_heads(vf, n_head)
    a = _merge_heads(_attention(q, k, v, mask=None))
    x = x + (a @ p["o_w"] + p["o_b"])
    h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
    h = gelu(h @ p["fc1_w"] + p["fc1_b"])
    return x + (h @ p["fc2_w"] + p["fc2_b"])


def _require_unquantized(tree: Params, who: str) -> None:
    """The plain block math (pp, sp, training) needs float weights; an int8
    QTensor leaf anywhere in ``tree`` would fail deep inside it with an
    opaque TypeError: raise the documented precondition instead. pp and sp
    hand in the encoder's tree, training the whole tree."""
    if any(not t.is_floating_point() for t in flatten(tree).values()):
        raise ValueError(
            f"{who} requires unquantized params (the plain torch block "
            f"math); got int8 QTensor leaves: keep a bf16/f32 copy")


def _stage_run(blocks: Params, x: torch.Tensor, n_head: int,
               gelu) -> torch.Tensor:
    """Run x through one stage's local layer stack, as on one device."""
    n = next(iter(blocks.values())).shape[0]
    for i in range(n):
        x = _plain_block(x, _layer(blocks, i), n_head, gelu)
    return x


@dataclasses.dataclass
class StagedBlocks:
    """A stacked layer tree placed on a (dp, pp) mesh: ``stages[i][s]`` is
    stage s's L/pp layers on ``mesh.devices[i][s]``."""

    mesh: Mesh
    axis: str
    stages: List[List[Params]]


def blocks_shard_put(blocks: Params, mesh: Mesh,
                     axis: str = "pp") -> StagedBlocks:
    """Place the stacked per-layer tree with its leading L axis split over
    the pp axis: each stage's device holds its own L/pp layers (one copy a
    dp row; a device named twice shares the slice). The slices and copies
    are torch ops, so a trainable tree's gradients flow back through
    them."""
    n_stages = mesh.shape[axis]
    n_layer = next(iter(blocks.values())).shape[0]
    if n_layer % n_stages:
        raise ValueError(f"{n_layer} layers do not split over "
                         f"{axis}={n_stages}")
    per = n_layer // n_stages
    return StagedBlocks(mesh, axis, [
        [{k: v[s * per:(s + 1) * per].to(dev) for k, v in blocks.items()}
         for s, dev in enumerate(row)] for row in mesh.devices])


def pipeline_blocks(blocks, x: torch.Tensor, mesh: Mesh, n_head: int, gelu,
                    n_micro: Optional[int] = None,
                    axis: str = "pp") -> torch.Tensor:
    """Run (B, T, d) activations through the full stacked layer tree with
    the layer axis split over ``axis`` of ``mesh``.

    GPipe schedule over ``n_micro + pp - 1`` steps: at step t stage s runs
    microbatch t - s (when there is one) on its device, and its output
    moves on to stage s + 1's; the last stage banks finished microbatch
    t - (pp - 1). Under dp, dp row i of stages carries rows
    [i mb/dp, (i + 1) mb/dp) of every microbatch of mb rows. ``blocks`` is
    the stacked tree, or a :class:`StagedBlocks` from
    :func:`blocks_shard_put` on this mesh, reused as placed (one placed on
    another mesh raises ValueError). The result is
    put back together in batch order on x's device."""
    n_stages = mesh.shape[axis]
    dp = mesh.shape.get("dp", 1)
    b = x.shape[0]
    n_micro = n_micro or n_stages
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    if dp > 1 and mb % dp:
        raise ValueError(
            f"microbatch size {mb} (batch {b} / n_micro {n_micro}) not "
            f"divisible by dp {dp}")
    # place the stack once; reuse a placement the caller already made
    # (re-placing the weights per encode call is what pp exists to avoid)
    if not isinstance(blocks, StagedBlocks):
        blocks = blocks_shard_put(blocks, mesh, axis)
    elif (blocks.mesh, blocks.axis) != (mesh, axis):
        raise ValueError("the blocks are placed on another mesh")
    rows = mb // dp
    last = n_stages - 1
    # banked[m][i]: microbatch m's dp row i out of the last stage
    banked: List[List[Optional[torch.Tensor]]] = [
        [None] * dp for _ in range(n_micro)]
    # inbox[i][s]: what stage s of dp row i runs this step, (m, input)
    inbox: List[Dict[int, Tuple[int, torch.Tensor]]] = [{} for _ in
                                                        range(dp)]
    for t in range(n_micro + n_stages - 1):
        for i, devs in enumerate(mesh.devices):
            if t < n_micro:
                lo = t * mb + i * rows
                inbox[i][0] = (t, x[lo:lo + rows].to(devs[0]))
            nxt: Dict[int, Tuple[int, torch.Tensor]] = {}
            for s, (m, inp) in sorted(inbox[i].items()):
                y = _stage_run(blocks.stages[i][s], inp, n_head, gelu)
                if s == last:
                    banked[m][i] = y
                else:
                    nxt[s + 1] = (m, y.to(devs[s + 1]))
            inbox[i] = nxt
    return torch.cat([z.to(x.device) for per_m in banked for z in per_m])


def encode_pipelined(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                     mesh: Mesh, n_micro: Optional[int] = None,
                     compute_dtype=torch.float32,
                     axis: str = "pp") -> torch.Tensor:
    """Pipeline-parallel twin of ``models/whisper.py::encode`` (the plain
    path's numerics): the conv stem, the ``pos`` add and ``ln_post`` on
    the mesh's first device, the block stack pipelined over the pp axis.

    Requires ``cfg.n_audio_layer % pp == 0`` and unquantized params. The
    kernels are never reached (pp runs the plain block math, as the
    reference does); under grad mode the result is differentiable wrt the
    mel and every parameter."""
    n_stages = mesh.shape[axis]
    if cfg.n_audio_layer % n_stages:
        raise ValueError(
            f"n_audio_layer {cfg.n_audio_layer} not divisible by "
            f"pp {n_stages}")
    _require_unquantized(params["encoder"], "encode_pipelined")
    disable_tf32()
    enc = params["encoder"]
    gelu = _gelu_fast if compute_dtype == torch.bfloat16 else _gelu
    x = mel.to(mesh.first).transpose(-1, -2).to(compute_dtype)
    x = gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], stride=1))
    x = gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], stride=2))
    x = x + enc["pos"].to(compute_dtype)
    x = pipeline_blocks(enc["blocks"], x, mesh, cfg.n_audio_head, gelu,
                        n_micro=n_micro, axis=axis)
    return _layer_norm(x, enc["ln_post_g"], enc["ln_post_b"])
