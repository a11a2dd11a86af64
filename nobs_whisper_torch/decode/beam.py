"""Batched beam-search decoding (port of ``decode/beam.py``).

Semantics are openai-whisper's BeamSearchDecoder, as in the reference: each
step's candidates are the beams' continuations, eot candidates retire into
a finished pool that fills without replacement (the first K finishers are
kept), the best K non-eot candidates are the next actives; the search ends
when K sequences finished or the token budget is out (then the pool is
topped up with the best actives); the pick is the highest cum / len.

The reference runs the loop as one jitted ``while_loop``. Here it is an
eager Python loop over device tensors, as the port's greedy loop: beams are
a flattened B x K row axis through the same decoder and rules, and the loop
stops when every pool is full (checked every ``_EXIT_CHECK`` steps, one
host sync each; once a pool is full, later steps change nothing that the
result reads) or at ``sample_len``.

Ties: ``jax.lax.top_k`` and ``jnp.argsort`` put the lower index first among
equal values, ``torch.topk`` does not promise an order. Every selection
here is a stable descending sort sliced to its first k, so ties resolve as
in the reference (at bf16, equal log-probabilities are common).

The cache reorder is ``index_select`` along the row axis into a second
buffer: the same permutation as the reference's one-hot matmul (which it
chose because the TPU's matrix unit beat its gather), bit for bit;
``NWT_BEAM_GATHER_REORDER`` selects this same function. ``NWT_BEAM_ANCESTRY``
keeps the cache in place and reads it through ancestry pointers
(``models/whisper.py::_attention_kt_ancestry``), equal to the permuted
path up to f32 reassociation. Both knobs are read at each call.

On the packed bf16 cross-KV (``kt_xattn_default``: the bf16 serving path)
the K beams of an element share its one cross-KV (the grouped
cross-attention), so beam costs little more memory than greedy; on the
plain layout the cross-KV is repeated per beam, as in the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WhisperConfig
from ..models.whisper import (decoder_forward, init_kv_cache,
                              precompute_cross_kv, xattn_kernel_enabled)
from ..ops.attention_pallas import pack_cross_kv_bf16
from .greedy import _EXIT_CHECK, WindowResult, kt_xattn_default, pad_prompts
from .rules import RuleTables, apply_logit_rules

NEG = -1e30


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, the lower index first among equal values
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_step(cum_logprob: torch.Tensor,     # (B, K) active beam scores
              step_logprobs: torch.Tensor,   # (B, K, V) masked log-softmax
              fin_valid: torch.Tensor,       # (B, K) bool: filled pool slots
              eot: int,
              first_step: bool,              # only beam 0 is live
              ):
    """One step of beam bookkeeping, openai BeamSearchDecoder exact:

    - the active beams are the best K non-eot candidates by cumulative
      score, taken from the top 2K joint candidates (at most one eot per
      beam can outrank any of them);
    - an eot candidate finishes only if it outranks the K-th active (openai
      walks the candidates best first and stops once K actives are saved);
    - the pool fills without replacement: new finishers, best first, take
      the empty slots only.

    Returns (src_beam (B, K), new_token (B, K), new_cum (B, K), fin_slot
    (B, K): the pool slot of the j-th best new finisher (>= K: dropped),
    fin_src (B, K): its source beam, fin_score (B, K): its cumulative score
    with the eot)."""
    b, k, v = step_logprobs.shape
    dev = step_logprobs.device
    beams = torch.arange(k, device=dev)
    # at the first step all K beams are the same clone: expand beam 0 only
    live = (beams[None, :] == 0) if first_step else \
        torch.ones((1, k), dtype=torch.bool, device=dev)
    live = live.expand(b, k)
    cand = torch.where(live[..., None],
                       cum_logprob[..., None] + step_logprobs, NEG)
    scores2k, idx2k = _top_k(cand.reshape(b, k * v), 2 * k)
    src2k = idx2k // v
    tok2k = idx2k % v

    active = torch.where(tok2k == eot, NEG, scores2k)
    new_cum, a_idx = _top_k(active, k)
    src_beam = torch.gather(src2k, 1, a_idx)
    new_token = torch.gather(tok2k, 1, a_idx)

    fin = cum_logprob + step_logprobs[..., eot]
    fin_cand = torch.where(live & (fin > new_cum[:, -1:]), fin, NEG)
    fin_score, order = _top_k(fin_cand, k)
    pool_size = fin_valid.sum(dim=1, keepdim=True)
    fin_slot = torch.where(fin_score > NEG / 2, pool_size + beams[None, :],
                           k)
    return src_beam, new_token, new_cum, fin_slot, order, fin_score


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered along the beam axis by idx (B, K)."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _scatter_slots(dst: torch.Tensor, slot: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """dst (B, K, ...) with val's rows written at pool slots ``slot`` (B,
    K); slots >= K are dropped (``.at[].set(mode="drop")``)."""
    k = dst.shape[1]
    out = torch.cat([dst, dst[:, :1]], dim=1)       # slot K: the drop bin
    idx = slot.clamp(max=k)
    idx = idx.reshape(idx.shape + (1,) * (val.ndim - 2)).expand(val.shape)
    return out.scatter_(1, idx, val)[:, :k]


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s order of operations: (x - max) - log(sum(
    exp(x - max)))."""
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1,
                                         keepdim=True))


def beam_cross_kv(params, xa: torch.Tensor, cfg: WhisperConfig,
                  beam_size: int, packed_kv: bool):
    """The decoder's cross-KV for B x K beam rows: on the packed layout one
    shared set per element (f32 copies of the bf16 values, made once a
    window, unless K4 reads the bf16 itself: K = 1 under
    ``NWT_XATTN_KERNEL``), else the plain layout repeated per beam."""
    cross_kv = precompute_cross_kv(params, xa, cfg)
    if not packed_kv:
        return tuple(t.repeat_interleave(beam_size, dim=1) for t in cross_kv)
    kT, v = pack_cross_kv_bf16(cross_kv)
    if beam_size > 1 or not xattn_kernel_enabled():
        kT, v = {"kT": kT["kT"].float()}, {"v": v["v"].float()}
    return kT, v


@torch.inference_mode()
def beam_decode_window_impl(params, xa: torch.Tensor,
                            prompt_tokens: torch.Tensor,   # (B, P) left-padded
                            pad_lens: torch.Tensor,        # (B,)
                            sot_idx: torch.Tensor,         # (B,)
                            tables: RuleTables, cfg: WhisperConfig,
                            beam_size: int, sample_len: int,
                            compute_dtype=torch.float32,
                            packed_kv: bool = False):
    """Prefill and the step loop. Returns (fin_tokens (B, K, L), fin_len
    (B, K), fin_cum (B, K), fin_valid (B, K), act_tokens (B, K, L),
    act_cum (B, K), n_steps, no_speech_prob (B,)), device tensors and an
    int."""
    b, p_max = prompt_tokens.shape
    k = beam_size
    bk = b * k
    dev = xa.device
    rep = lambda x: x.repeat_interleave(k, dim=0)
    cross_kv = beam_cross_kv(params, xa, cfg, k, packed_kv)
    t_cache = min(-(-(p_max + sample_len) // 8) * 8, cfg.n_text_ctx)
    cache = init_kv_cache(cfg, bk, dtype=compute_dtype, t_ctx=t_cache,
                          device=dev)

    pad_rep = rep(pad_lens)
    logits_all, cache = decoder_forward(
        params, rep(prompt_tokens), 0, pad_rep, cache, cross_kv, cfg,
        compute_dtype)
    logits = logits_all[:, -1]
    sot_logits = logits_all[torch.arange(bk, device=dev), rep(sot_idx)]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[
        :, cfg.no_speech].reshape(b, k)[:, 0]

    ancestry = bool(os.environ.get("NWT_BEAM_ANCESTRY"))
    tb, eot = tables.timestamp_begin, tables.eot
    long = dict(dtype=torch.long, device=dev)
    tokens = torch.full((b, k, sample_len), eot, **long)
    cum = torch.zeros((b, k), dtype=torch.float32, device=dev)
    last = torch.zeros((b, k), **long)
    penult = torch.zeros((b, k), **long)
    max_ts = torch.full((b, k), tb - 1, **long)
    fin_tokens = torch.full((b, k, sample_len), eot, **long)
    fin_len = torch.zeros((b, k), **long)
    fin_cum = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
    fin_valid = torch.zeros((b, k), dtype=torch.bool, device=dev)
    own = torch.arange(k, **long)
    if ancestry:
        # anc[(b, q), t]: the beam row of element b whose KV at cache
        # position t is beam q's history; prefill wrote every row its own
        # copy, so it starts as the identity
        anc = own[None, :, None].expand(b, k, t_cache).contiguous()
    else:
        spare = tuple(torch.empty_like(c) for c in cache)
    row_base = (torch.arange(b, **long) * k)[:, None]

    n_steps = 0
    for step in range(sample_len):
        if step and step % _EXIT_CHECK == 0 and bool(fin_valid.all()):
            break
        masked = apply_logit_rules(
            logits.float(), tables, n_sampled=torch.full((bk,), step, **long),
            last_token=last.reshape(bk), penult_token=penult.reshape(bk),
            max_ts_token=max_ts.reshape(bk))
        logprobs = _log_softmax(masked).reshape(b, k, -1)
        src, tok, cum_next, fin_slot, fin_src, fin_score = beam_step(
            cum, logprobs, fin_valid, eot, step == 0)

        # new finishers into empty pool slots: the source beam's tokens
        # (the eot is not stored), length = step
        fin_tokens = _scatter_slots(fin_tokens, fin_slot,
                                    _gather_beams(tokens, fin_src))
        fin_len = _scatter_slots(fin_len, fin_slot,
                                 torch.full_like(fin_len, step))
        fin_cum = _scatter_slots(fin_cum, fin_slot, fin_score)
        fin_valid = _scatter_slots(fin_valid, fin_slot,
                                   torch.ones_like(fin_valid))

        tokens = _gather_beams(tokens, src)
        tokens[:, :, step] = tok
        penult = torch.gather(last, 1, src)
        last = tok
        max_ts = torch.gather(max_ts, 1, src)
        max_ts = torch.where(tok >= tb, torch.maximum(max_ts, tok), max_ts)
        cum = cum_next
        n_steps = step + 1
        if n_steps == sample_len:
            break            # the next logits would never be read
        if ancestry:
            # no cache movement: row q inherits src[q]'s history map, then
            # owns the slot the forward below writes
            anc = _gather_beams(anc, src)
            anc[:, :, p_max + step] = own
        else:
            flat_src = (row_base + src).reshape(bk)
            for c, s in zip(cache, spare):
                torch.index_select(c, 1, flat_src, out=s)
            cache, spare = spare, cache
        logits_next, cache = decoder_forward(
            params, tok.reshape(bk, 1), p_max + step, pad_rep, cache,
            cross_kv, cfg, compute_dtype,
            ancestry=anc.reshape(bk, t_cache) if ancestry else None,
            beam_k=k if ancestry else 0)
        logits = logits_next[:, 0]
    return (fin_tokens, fin_len, fin_cum, fin_valid, tokens, cum, n_steps,
            no_speech_prob)


def beam_decode_window(params, xa: torch.Tensor,
                       prompts: Sequence[Sequence[int]], cfg: WhisperConfig,
                       tables: RuleTables, beam_size: int = 5,
                       sample_len: Optional[int] = None,
                       compute_dtype=torch.float32) -> List[WindowResult]:
    """Host wrapper: run the beam loop, rank the finished by cum / len."""
    dev = xa.device
    prompt_np, pad_np = pad_prompts(prompts, cfg.eot)
    p_max = prompt_np.shape[1]
    sot_np = np.array([pad_np[i] + list(p).index(cfg.sot)
                       for i, p in enumerate(prompts)], np.int64)
    sample_len = sample_len or cfg.n_text_ctx // 2
    sample_len = min(sample_len, cfg.n_text_ctx - p_max)

    (fin_tokens, fin_len, fin_cum, fin_valid, act_tokens, act_cum, n_steps,
     nsp) = beam_decode_window_impl(
        params, xa, torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
        torch.as_tensor(pad_np, dtype=torch.long, device=dev),
        torch.as_tensor(sot_np, device=dev), tables.to(dev), cfg, beam_size,
        sample_len, compute_dtype, packed_kv=kt_xattn_default(compute_dtype))

    fin_tokens = fin_tokens.cpu().numpy()
    fin_len = fin_len.cpu().numpy()
    fin_cum = fin_cum.cpu().numpy()
    fin_valid = fin_valid.cpu().numpy()
    act_tokens = act_tokens.cpu().numpy()
    act_cum = act_cum.cpu().numpy()
    nsp = nsp.float().cpu().numpy()

    out: List[WindowResult] = []
    for i in range(len(prompts)):
        # candidates = the finished sequences; if the budget ran out
        # before K finished, top up with the best actives (openai
        # BeamSearchDecoder.finalize: their cum gains no eot logprob)
        cands: List[Tuple[List[int], float]] = []
        for j in range(beam_size):
            if fin_valid[i, j]:
                cands.append((fin_tokens[i, j, : fin_len[i, j]].tolist(),
                              float(fin_cum[i, j])))
        if len(cands) < beam_size:
            for j in np.argsort(-act_cum[i]):
                if len(cands) >= beam_size:
                    break
                cands.append((act_tokens[i, j, : n_steps].tolist(),
                              float(act_cum[i, j])))
        # rank by cum / len (openai MaximumLikelihoodRanker: the eot
        # logprob is in the sum, the divisor is the text length); cum /
        # (len + 1) is only the reported avg_logprob
        toks, cum = max(cands, key=lambda c: c[1] / max(len(c[0]), 1))
        out.append(WindowResult(
            tokens=toks, sum_logprob=cum,
            avg_logprob=cum / (len(toks) + 1),
            no_speech_prob=float(nsp[i]), temperature=0.0))
    return out
