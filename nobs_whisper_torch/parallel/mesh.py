"""Device mesh and sharding rules (port of ``parallel/mesh.py``).

A :class:`Mesh` is a (dp, tp) grid of ``torch.device``s:

- ``dp`` — data parallel over the window batch: each dp group runs the
  whole single-device program on its contiguous slice of the rows
  (``parallel/spmd.py``);
- ``tp`` — tensor parallel over attention heads and FFN columns
  (``parallel/tp.py``).

Shardings are Megatron-style, as the reference's docstring has them:
q/k/v and fc1 split on the output feature axis, o and fc2 on the input
feature axis, so each block needs one sum across tp. Where the reference
places a tree on the mesh with ``NamedSharding``s, :func:`shard_params`
here builds one parameter tree per mesh position, on that position's
device, holding only that tp rank's slices. Its slices and copies are
torch ops (``tensor_split``, ``.to``), so under grad mode the shards of a
trainable tree stay in the autograd graph: the dp x tp train step
(``models/training.py``) shards its master tree this way at each step,
and a replicated leaf's gradient sums over its copies.

The other axes of the reference, pp and sp, have meshes of their own
(``parallel/pipeline.py``, ``parallel/seqparallel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.quant import is_quantized

# the port's stand-in for the reference's 8 virtual CPU devices
# (tests/conftest.py forces 8 host devices for the JAX package)
CPU_DEVICE_COUNT = 8


def P(*axes: Optional[str]) -> Tuple[Optional[str], ...]:
    """A partition spec: the mesh axis each tensor axis is split over
    (None: not split), as ``jax.sharding.PartitionSpec``."""
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices; ``devices[i][j]`` is row i's position j. The
    serving mesh is (dp, tp): dp group i's tp rank j. The pipeline mesh is
    (dp, pp) (``parallel/pipeline.py``); a one-axis mesh (sp,
    ``parallel/seqparallel.py``) is one row. A device may appear more than
    once (a one-card machine runs dp=2 on ``cuda:0`` twice)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...] = ("dp", "tp")

    @property
    def shape(self) -> Dict[str, int]:
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: len(self.devices[0])}
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def default_devices(n: Optional[int], device="cuda") -> List[torch.device]:
    """A mesh's devices when the caller names none: every visible card,
    or, when ``device`` asks for the CPU, the CPU named n times
    (:data:`CPU_DEVICE_COUNT` times when n is None)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (n if n is not None
                                        else CPU_DEVICE_COUNT)
    from ..core.device import resolve_device
    resolve_device(dev)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices=None,
              device="cuda") -> Mesh:
    """Build a (dp, tp) mesh; dp defaults to n_devices // tp.

    With ``devices`` None the devices are :func:`default_devices`' (the CPU
    named dp * tp times under a CPU request). Raises ValueError when
    dp * tp is not the number of devices."""
    if devices is None:
        devices = default_devices(dp * tp if dp is not None else None,
                                  device)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return Mesh(tuple(tuple(devices[i * tp:(i + 1) * tp])
                      for i in range(dp)))


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Partition spec tree matching the stacked param tree (the
    reference's tree). The leading layer axis is never split; feature axes
    are tensor-parallel, and each leaf's spec names the axis split over
    tp; everything batch-related is dp, at the activations."""
    def enc_block_specs(cross: bool):
        s = {
            "ln1_g": P(None, None), "ln1_b": P(None, None),
            "q_w": P(None, None, "tp"), "q_b": P(None, "tp"),
            "k_w": P(None, None, "tp"),
            "v_w": P(None, None, "tp"), "v_b": P(None, "tp"),
            "o_w": P(None, "tp", None), "o_b": P(None, None),
            "ln2_g": P(None, None), "ln2_b": P(None, None),
            "fc1_w": P(None, None, "tp"), "fc1_b": P(None, "tp"),
            "fc2_w": P(None, "tp", None), "fc2_b": P(None, None),
        }
        if cross:
            s.update({
                "lnx_g": P(None, None), "lnx_b": P(None, None),
                "xq_w": P(None, None, "tp"), "xq_b": P(None, "tp"),
                "xk_w": P(None, None, "tp"),
                "xv_w": P(None, None, "tp"), "xv_b": P(None, "tp"),
                "xo_w": P(None, "tp", None), "xo_b": P(None, None),
            })
        return s

    return {
        "encoder": {
            # the conv stem stays replicated: its output feeds LayerNorm,
            # which needs the whole feature axis
            "conv1_w": P(None, None, None), "conv1_b": P(None),
            "conv2_w": P(None, None, None), "conv2_b": P(None),
            "pos": P(None, None),
            "blocks": enc_block_specs(cross=False),
            "ln_post_g": P(None), "ln_post_b": P(None),
        },
        "decoder": {
            "tok_emb": P("tp", None),
            # quantized logit projection (d, V): split the vocabulary axis
            "tok_emb_q": P(None, "tp"),
            "pos": P(None, None),
            "blocks": enc_block_specs(cross=True),
            "ln_g": P(None), "ln_b": P(None),
        },
    }


@dataclasses.dataclass
class ShardedParams:
    """One parameter tree per mesh position: ``trees[i][j]`` on
    ``mesh.devices[i][j]``, holding tp rank j's slices; ``vocab[j]`` is
    rank j's [lo, hi) of the decoder's vocabulary."""

    mesh: Mesh
    trees: List[List[Any]]
    vocab: List[Tuple[int, int]]


def _split(t: torch.Tensor, spec, tp: int, rank: int, name: str,
           even: bool = True) -> torch.Tensor:
    if tp == 1 or "tp" not in spec:
        return t
    axis = spec.index("tp")
    if even and t.shape[axis] % tp:
        raise ValueError(f"{name}: axis {axis} of {tuple(t.shape)} does "
                         f"not split over tp={tp}")
    return torch.tensor_split(t, tp, dim=axis)[rank].contiguous()


def shard_params(params, mesh: Mesh) -> ShardedParams:
    """Place a param tree on the mesh with its tensor-parallel splits.

    For int8 leaves ({"q": (..., K, N), "s": (..., 1, N)}), q takes the
    weight's split; s drops a split of the contraction axis (its K is 1)
    and keeps the out-channel split. A QTensor's K-major copy ``"qt"``
    (made by the kernels on the card) goes with it at tp == 1 and is
    dropped under tp, where the kernels are off. The vocabulary may split
    unevenly (``torch.tensor_split``); heads and FFN columns must split
    evenly. At tp == 1 a position on the tree's own device shares its
    tensors."""
    if isinstance(params, ShardedParams):
        if params.mesh != mesh:
            raise ValueError("params are sharded over another mesh")
        return params
    tp = mesh.shape["tp"]
    specs = param_pspecs(params)
    blocks = params["decoder"]["blocks"]
    if tp > 1 and "qkv_w" in blocks:
        raise NotImplementedError(
            "a fused decoder qkv projection (ops/quant.py::fuse_qkv) has "
            "no tp split; shard the unfused tree")
    # torch.tensor_split's sizes: the first n_vocab % tp slices one longer
    n_vocab = params["decoder"]["tok_emb"].shape[0]
    sizes = [n_vocab // tp + (r < n_vocab % tp) for r in range(tp)]
    vocab = [(sum(sizes[:r]), sum(sizes[:r + 1])) for r in range(tp)]

    def walk(p, s, rank, dev, name):
        if is_quantized(p):
            parts = list(s) if len(s) else []
            s_spec = (P(*(parts[:-2] + [None] + parts[-1:]))
                      if len(parts) >= 2 else P())
            even = not name.endswith("tok_emb_q")
            out = {"q": _split(p["q"], s, tp, rank, name, even).to(dev),
                   "s": _split(p["s"], s_spec, tp, rank, name,
                               even).to(dev)}
            if tp == 1 and "qt" in p:
                out["qt"] = p["qt"].to(dev)
            return out
        if isinstance(p, dict):
            return {k: walk(v, s[k] if isinstance(s, dict) and k in s
                            else P(), rank, dev, f"{name}.{k}")
                    for k, v in p.items()}
        return _split(p, s, tp, rank, name,
                      even=not name.endswith("tok_emb")).to(dev)

    trees = [[walk(params, specs, j, dev, "params")
              for j, dev in enumerate(row)] for row in mesh.devices]
    return ShardedParams(mesh=mesh, trees=trees, vocab=vocab)


def batch_shards(x, dp: int) -> list:
    """Split the leading batch axis into ``dp`` contiguous shards (the
    port's ``batch_sharding``): tensors and numpy arrays by slicing, lists
    by slicing. The batch must divide by dp, as a dp-sharded array's
    must in the reference."""
    n = len(x)
    if n % dp:
        raise ValueError(f"batch of {n} does not split over dp={dp}; pad "
                         "it to a multiple of dp (the batcher does)")
    k = n // dp
    return [x[i * k:(i + 1) * k] for i in range(dp)]


def gather_batch(parts: Sequence, device=None):
    """Put dp shards back together in shard order: tensors concatenated
    on ``device`` (default the first shard's), lists joined, tuples
    element-wise."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        dev = device if device is not None else first.device
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(first, tuple):
        return tuple(gather_batch([p[i] for p in parts], device)
                     for i in range(len(first)))
    if isinstance(first, list):
        return [x for p in parts for x in p]
    raise TypeError(f"cannot gather shards of {type(first).__name__}")
