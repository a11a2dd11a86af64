"""Sequence parallelism (sp) for the encoder transformer stack (port of
``parallel/seqparallel.py``).

The encoder's time axis is split over sp devices. Every per-row op
(LayerNorm, projections, MLP, residual) is parallel over rows, so the
only collectives in a block are the two all-gathers that make the full
sequence's k and v from the per-rank projections before attention: each
rank attends its own query rows against the full sequence. Activations
and the O(T^2) scores split T ways while the weights are replicated, the
complement of tp.

Each rank runs in a host thread of its own on its device
(``parallel/spmd.py::run_threads``, as mesh positions run), and the gathers
are ``parallel/tp.py``'s barrier exchanges, which are differentiable: a
loss on the result takes its gradient with one ``backward()`` from the
calling thread. The block math is ``parallel/pipeline.py::_plain_block``
with its ``kv_map`` hook, which pp shares; one device keeps its own copy
in ``models/whisper.py::_encode``, and the CPU tests and chip_smoke.py's
``[train]`` phase hold the two to each other.
As in the reference, sp is a capability axis, not a serving path.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.config import WhisperConfig
from ..core.device import disable_tf32
from ..models.whisper import _conv1d, _gelu, _gelu_fast, _layer, _layer_norm
from .mesh import Mesh, default_devices
from .pipeline import _plain_block, _require_unquantized
from .spmd import run_threads
from .tp import TPGroup

Params = Dict[str, Any]


def make_sp_mesh(sp: int, devices=None, device="cuda") -> Mesh:
    """One-axis mesh of sp devices. With ``devices`` None: every visible
    card, or the CPU named sp times when ``device`` asks for the CPU.
    Raises ValueError when sp is not the number of devices."""
    if devices is None:
        devices = default_devices(sp, device)
    devices = [torch.device(d) for d in devices]
    if len(devices) != sp:
        raise ValueError(f"sp({sp}) != device count ({len(devices)})")
    return Mesh((tuple(devices),), axis_names=("sp",))


def encode_seq_parallel(params: Params, mel: torch.Tensor,
                        cfg: WhisperConfig, mesh: Mesh,
                        compute_dtype=torch.float32,
                        axis: str = "sp") -> torch.Tensor:
    """Sequence-parallel twin of ``models/whisper.py::encode`` (the plain
    path's numerics). The conv stem and the ``pos`` add run on the mesh's
    first device (the K=3 convs have one-frame halos across shard edges);
    then rank r holds rows [r T/sp, (r + 1) T/sp) of the residual stream
    for the whole block stack and ``ln_post``, and the result is put back
    together in rank order on the first device. Requires T % sp == 0 and
    unquantized params."""
    devices = mesh.devices[0]
    n = mesh.shape[axis]
    n_head = cfg.n_audio_head
    _require_unquantized(params["encoder"], "encode_seq_parallel")
    disable_tf32()
    enc = params["encoder"]
    gelu = _gelu_fast if compute_dtype == torch.bfloat16 else _gelu
    x = mel.to(mesh.first).transpose(-1, -2).to(compute_dtype)
    x = gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], stride=1))
    x = gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], stride=2))
    x = x + enc["pos"].to(compute_dtype)
    t = x.shape[1]
    if t % n:
        raise ValueError(f"T {t} not divisible by sp {n}")
    rows = t // n
    group = TPGroup(devices)

    def rank_job(r: int):
        dev = devices[r]

        def gather_seq(z):
            # the full sequence's k/v from every rank's projection
            return group.all_gather(r, z, dim=1)

        def fn():
            blocks = {k: v.to(dev) for k, v in enc["blocks"].items()}
            xs = x[:, r * rows:(r + 1) * rows].to(dev)
            for i in range(cfg.n_audio_layer):
                xs = _plain_block(xs, _layer(blocks, i), n_head, gelu,
                                  kv_map=gather_seq)
            return _layer_norm(xs, enc["ln_post_g"].to(dev),
                               enc["ln_post_b"].to(dev))
        return f"nwt-sp-{r}", dev, fn, group

    out = run_threads([rank_job(r) for r in range(n)])
    return torch.cat([z.to(mesh.first) for z in out], dim=1)
