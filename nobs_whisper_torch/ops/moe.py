"""The dynamic-capacity mixture of experts of ``models/uni_moe.py``: the
router, the dispatch plan and the grouped SwiGLU expert FFN.

It replaces no TPU kernel: the JAX package serves Whisper, which has no
expert layer. It was added for Uni-MoE-2.0-Omni's language model, whose
routed experts hold 91% of a decode step's bytes and take ~84% of a
prefill token's operations.

* **Router** (plain torch on the device, no host sync, so that a decode
  step still captures as one CUDA graph): the gate's f32 logits over the
  routed and the null experts, softmax, sorted descending; a token takes
  the shortest prefix whose sum reaches ``top_p``, at most ``top_k``
  experts. Each slot gets an expert id (routed ``0..R-1``, null ``R..``,
  -1 a slot not taken or a pad token) and a weight: a routed expert's own
  probability, not renormalised; 0 for the null and an empty slot.
* **Dispatch plan** (torch on the device, fixed shapes): the (token,
  slot) pairs sorted by expert, each expert's run padded to a multiple
  of the block's rows. Null slots and empty slots take no row.
* **Expert FFN**, two CUDA kernels (``csrc/moe.cu``, bf16 ``wgmma`` fed
  by TMA; its source note says what bounds them and how the design
  answers that) whose names start with ``moe_``: ``moe_gate_up_kernel``
  writes h = silu(x Wg) * (x Wu) (f32 sums, bf16 h, in the plan's order)
  from x's rows gathered into that order; ``moe_down_kernel`` computes h
  Wd times the pair's weight and writes it in f32 at the pair's own row
  (its K split into ``splits`` parts where a decode batch's tiles would
  not fill the card), so the scatter needs no atomics, and the layer's
  output, a token's slots and the splits summed here in a fixed order,
  is the same from run to run. Each grid covers the batch's worst case
  (every pair routed, every run padded): its size depends on the token
  count alone, and a block past the last run exits at once. The shared
  experts run through the same kernels, as a group every token takes
  with weight 1.

The plain version (:func:`expert_ffn_plain`) walks the same plan block by
block with the kernels' arithmetic; a CPU tensor takes it, a CUDA tensor
launches the kernels or raises. ``moe_launch_count`` counts the launches
(``ops/_build.py::count``: a CUDA graph's replay counts what it
replays).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build

moe_launch_count = 0

# the kernels' row block and down tile width (csrc/moe.cu MOE_BM, MOE_BN)
BM = 128
_DOWN_BN = 256
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"nwt_moe_expert_ffn": [_P] * 8 + [_I] * 6 + [_P]}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def down_splits(n_blocks: int, d: int, f: int, sms: int) -> int:
    """The K slabs a split of the down kernel: its worst-case tiles times
    the splits fill two waves of the card's ``sms`` (a decode batch's 14
    column tiles an expert would leave most SMs idle), at most 8 splits."""
    tiles = n_blocks * -(-d // _DOWN_BN)
    splits = min(8, max(1, -(-2 * sms // tiles)))
    return -(-(f // 64) // splits)


def route(x: torch.Tensor, gate_w: torch.Tensor, top_p: float, top_k: int,
          n_routed: int, real=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d), gate_w (d, E) over the routed and the null experts ->
    (ids (T, top_k) long, weights (T, top_k) f32); ``real`` (T,) bool
    marks the tokens routed (a pad takes no slot)."""
    p = torch.softmax(x.float() @ gate_w.float(), dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True)
    before = torch.cat([torch.zeros_like(ps[:, :1]),
                        torch.cumsum(ps, dim=-1)[:, :-1]], dim=-1)
    take = (before < top_p)[:, :top_k]
    if real is not None:
        take = take & real[:, None]
    ids = torch.where(take, order[:, :top_k], -1)
    w = torch.where(take & (order[:, :top_k] < n_routed), ps[:, :top_k],
                    0.0)
    return ids, w


class Plan(NamedTuple):
    """``rows`` (blocks x bm,) int32: pair ids (token x top_k + slot) in
    the padded order, ``n_pairs`` in a padding slot; ``block_expert``
    (blocks,) int32: a block's expert, -1 past the last run."""
    rows: torch.Tensor
    block_expert: torch.Tensor
    n_pairs: int
    bm: int


def plan(ids: torch.Tensor, n_experts: int, bm: int) -> Plan:
    """The dispatch plan of ``ids`` (T, K): the pairs whose id is an
    expert below ``n_experts``, sorted by expert, each run padded to a
    multiple of ``bm``."""
    flat = ids.reshape(-1)
    n, dev = flat.numel(), flat.device
    e = torch.where((flat >= 0) & (flat < n_experts), flat, n_experts)
    counts = torch.zeros(n_experts + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, e, torch.ones_like(e))
    counts = counts[:n_experts]
    padded = (counts + bm - 1) // bm * bm
    ends = torch.cumsum(padded, 0)
    raw_start = torch.cumsum(counts, 0) - counts
    n_blocks = -(-(n + n_experts * (bm - 1)) // bm)
    slots = n_blocks * bm
    order = torch.argsort(e, stable=True)
    se = e[order]
    ok = se < n_experts
    sc = torch.clamp(se, max=n_experts - 1)
    dest = torch.where(ok, ends[sc] - padded[sc] + torch.arange(
        n, device=dev) - raw_start[sc], slots)
    rows = torch.full((slots + 1,), n, dtype=torch.int32, device=dev)
    rows.scatter_(0, dest, order.to(torch.int32))
    be = torch.searchsorted(ends, torch.arange(n_blocks, device=dev) * bm,
                            right=True)
    be = torch.where(be < n_experts, be, -1).to(torch.int32)
    return Plan(rows[:slots], be, n, bm)


def expert_ffn_plain(x: torch.Tensor, pl: Plan, weights: torch.Tensor,
                     w13: torch.Tensor, w2: torch.Tensor,
                     top_k: int) -> torch.Tensor:
    """The kernels' arithmetic, block by block: (n_pairs, d) f32, a
    pair's weighted expert output at its row, 0 where it has none."""
    f = w2.shape[1]
    y = torch.zeros(pl.n_pairs, x.shape[1], dtype=torch.float32,
                    device=x.device)
    wt = weights.reshape(-1).float()
    for b, e in enumerate(pl.block_expert.tolist()):
        if e < 0:
            continue
        r = pl.rows[b * pl.bm:(b + 1) * pl.bm].long()
        r = r[r < pl.n_pairs]
        if not r.numel():
            continue
        xa = x[r // top_k].float()
        g = xa @ w13[e, :, :f].float()
        u = xa @ w13[e, :, f:].float()
        h = (F.silu(g) * u).to(x.dtype).float()
        y[r] = (h @ w2[e].float()) * wt[r, None]
    return y


def expert_ffn(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
               w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The experts of ``w13`` (E, d, 2F: gate then up) and ``w2`` (E, F,
    d) on x (T, d), each (token, slot) of ``ids`` (T, K) whose id is one
    of them, weighted by ``weights`` (T, K) -> (T, d) f32, a token's slots
    summed."""
    _build.no_autograd("moe expert FFN", x, w13, w2)
    t, d = x.shape
    k = ids.shape[1]
    n_e, f = w2.shape[0], w2.shape[1]
    pl = plan(ids, n_e, BM)
    if x.device.type == "cpu":
        y = expert_ffn_plain(x, pl, weights, w13, w2, k)
        return y.view(t, k, d).sum(1)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.dtype == w13.dtype == w2.dtype == torch.bfloat16):
        raise ValueError(f"the expert kernels take bf16 x and weights; got "
                         f"{x.dtype}, {w13.dtype}, {w2.dtype}")
    if w13.shape != (n_e, d, 2 * f) or not (w13.is_contiguous()
                                            and w2.is_contiguous()):
        raise ValueError(f"w13 {tuple(w13.shape)} and w2 {tuple(w2.shape)} "
                         f"must be contiguous (E, {d}, 2F) and (E, F, {d})")
    if d % 64 or f % 64:
        raise ValueError(f"the expert kernels take d and F multiples of 64; "
                         f"got {d}, {f}")
    fn = _build.load("moe", _SIG).nwt_moe_expert_ffn
    dev = x.device
    n_mb = pl.block_expert.numel()
    n = t * k
    # x's rows in the plan's order (a padding slot reads row 0, unused);
    # every operand held in a name until the launch
    tok = torch.where(pl.rows < n, pl.rows // k, 0).long()
    xs = x.index_select(0, tok)
    if w13.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("the expert kernels' weights must be 16-byte "
                         "aligned (the tensor maps' base address)")
    wt = weights.reshape(-1).float().contiguous()
    per_split = down_splits(n_mb, d, f, _sm_count(dev.index or 0))
    splits = -(-(f // 64) // per_split)
    h = torch.empty((n_mb * BM, f), dtype=x.dtype, device=dev)
    y = torch.zeros((splits, n, d), dtype=torch.float32, device=dev)
    err = fn(xs.data_ptr(), w13.data_ptr(), w2.data_ptr(),
             pl.rows.data_ptr(), pl.block_expert.data_ptr(), wt.data_ptr(),
             h.data_ptr(), y.data_ptr(), n, n_mb, d, f, n_e, per_split,
             torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "moe expert FFN")
    _build.count(globals(), "moe_launch_count", 2)
    return y.view(splits, t, k, d).sum(dim=(0, 2))


def moe_ffn(x: torch.Tensor, layer: dict, cfg, real=None):
    """One layer's FFN on x (T, d): the routed experts by the router's
    choice and the shared experts, summed -> ((T, d) f32, ids (T, top_k)
    with the null experts' ids). ``layer``: ``gate`` (d, routed + null),
    ``w13``/``w2`` the routed experts', ``s13``/``s2`` the shared."""
    ids, w = route(x, layer["gate"], cfg.top_p, cfg.top_k, cfg.n_routed,
                   real)
    out = expert_ffn(x, ids, w, layer["w13"], layer["w2"])
    t, n_s = x.shape[0], cfg.n_shared
    if n_s:
        sid = torch.arange(n_s, device=x.device).expand(t, n_s)
        sw = torch.ones((t, n_s), dtype=torch.float32, device=x.device)
        if real is not None:
            sid = torch.where(real[:, None], sid, -1)
        out = out + expert_ffn(x, sid, sw, layer["s13"], layer["s2"])
    return out, ids
