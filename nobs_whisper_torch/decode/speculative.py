"""Exact speculative greedy window decoding (port of
``decode/speculative.py``).

A pass drafts K tokens with a cheap draft, then verifies them in ONE
target forward over ``[last, d_0 .. d_{K-1}]``: the accepted prefix plus
the target's own next token are emitted, so the emitted sequence is token
for token the sequential greedy one whatever the draft proposes (a bad
draft only costs passes).

As in the reference, the cache never rewinds: every pass writes a uniform
block of K+1 slots (K in the draft's cache), and the rejected slots stay
in place as garbage, masked out of every later read by a per-row slot
bitmap (``decoder_forward``'s ``slot_mask``); positions come from an
explicit per-row base (``pos_base``), since cache index minus pad no
longer equals the sequence position once holes appear.

The draft is either the target itself over time-pooled cross-KV (the
raw cross-KV, mean-pooled ``draft_pool`` x along audio time: "self
draft") or a second model that shares the tokenizer and reads the
target's encoder states (the distil pairing). The draft's cross-KV stays
plain (never packed or quantized), so its forwards never take K4 or K5.

The reference runs the passes as a ``lax.while_loop``; here, as in
``decode/greedy.py``, they are eager Python loops: the cache positions,
the pass budget and the tail length are host ints, and the loop's
``any(active)`` condition is one host sync a pass.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WhisperConfig
from ..models.whisper import (decoder_forward, init_kv_cache,
                              precompute_cross_kv)
from .rules import RuleTables, apply_logit_rules_scored


def pool_cross_kv(cross_kv: Tuple[torch.Tensor, torch.Tensor],
                  pool: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-pool (xk, xv) (L, B, H, T, Dh) by ``pool`` along audio time,
    dropping the last T % pool positions. The mean sums in f32 in order
    and multiplies by the f32 reciprocal of ``pool``, then rounds once to
    the input dtype: ``jnp.mean``'s values as XLA computes them, bit for
    bit, also on bf16."""
    if pool <= 1:
        return cross_kv
    t2 = cross_kv[0].shape[-2] // pool

    def _p(a):
        a32 = a[..., : t2 * pool, :].float().reshape(
            *a.shape[:-2], t2, pool, a.shape[-1])
        acc = a32[..., 0, :]
        for i in range(1, pool):
            acc = acc + a32[..., i, :]
        inv = torch.tensor(1.0 / pool, dtype=torch.float32, device=a.device)
        return (acc * inv).to(a.dtype)

    return _p(cross_kv[0]), _p(cross_kv[1])


def _flat_rules(logits, tables, n_s, last, penult, max_ts):
    """apply_logit_rules_scored over a (B, S, V) block: flatten rows.
    Returns (greedy tokens, greedy logit, lse), each (B, S)."""
    b, s, v = logits.shape
    masked, lse, greedy_logit = apply_logit_rules_scored(
        logits.reshape(b * s, v), tables,
        n_sampled=n_s.reshape(-1), last_token=last.reshape(-1),
        penult_token=penult.reshape(-1), max_ts_token=max_ts.reshape(-1))
    tok = torch.argmax(masked, dim=-1)
    return (tok.reshape(b, s), greedy_logit.reshape(b, s),
            lse.reshape(b, s))


def _first_true(x: torch.Tensor, none: int) -> torch.Tensor:
    """Index of the first True of each row of a (B, S) bool, ``none``
    where the row has none (``torch.argmax`` takes no bool)."""
    return torch.where(x.any(1), torch.argmax(x.to(torch.uint8), dim=1),
                       torch.full_like(x[:, 0], none, dtype=torch.long))


@torch.inference_mode()
def decode_window_speculative_impl(
    params,
    draft_params,                    # == params for a self-draft
    xa: torch.Tensor,                # (B, T_audio, d) encoder states
    prompt_tokens: torch.Tensor,     # (B, P) long, LEFT-padded
    pad_lens: torch.Tensor,          # (B,) long
    sot_idx: torch.Tensor,           # (B,) long
    tables: RuleTables,
    cfg: WhisperConfig,
    draft_cfg: WhisperConfig,
    sample_len: int,
    k_draft: int,
    draft_pool: int,
    compute_dtype=torch.float32,
    xattn_bf16: bool = False,
    q8_kv: bool = False,
    self_draft: bool = True,
):
    """Greedy-only speculative twin of ``decode_window_impl``: returns
    (tokens, n_sampled, sum_logprob, no_speech_prob) device tensors and
    the pass count (a host int: phase-1 passes plus phase-2 steps).

    ``self_draft`` is a flag passed down by the caller (``draft is
    None``), never an identity test of the two parameter sets."""
    from .greedy import window_cross_kv

    b, p_max = prompt_tokens.shape
    dev = xa.device
    K = k_draft
    tb, eot = tables.timestamp_begin, tables.eot

    # cross-KV: the target's in the greedy path's layout; the draft's raw
    # and pooled
    if self_draft:
        raw = precompute_cross_kv(params, xa, cfg)
        d_cross = pool_cross_kv(raw, draft_pool)
    else:
        raw = None
        d_cross = pool_cross_kv(
            precompute_cross_kv(draft_params, xa, draft_cfg), draft_pool)
    cross_kv = window_cross_kv(params, xa, cfg, q8_kv, xattn_bf16, raw)
    del raw

    # caches sized for a pass budget of ceil(sample_len / 2) passes of K+1
    # slots plus a sequential tail for what is left (each budgeted pass
    # emits at least one token); no clip to n_text_ctx: positions come
    # from pos_base, not from the cache index
    budget = max(1, -(-sample_len // 2))
    tail = sample_len - budget
    t_len = -(-(p_max + budget * (K + 1) + tail) // 8) * 8
    d_len = -(-(p_max + budget * K) // 8) * 8
    cache = init_kv_cache(cfg, b, dtype=compute_dtype, t_ctx=t_len,
                          device=dev)
    dcache = init_kv_cache(draft_cfg, b, dtype=compute_dtype, t_ctx=d_len,
                           device=dev)

    # prefills: the prompt's KVs valid, the pad masked by pad_lens
    logits_all, cache = decoder_forward(
        params, prompt_tokens, 0, pad_lens, cache, cross_kv, cfg,
        compute_dtype)
    _, dcache = decoder_forward(
        draft_params, prompt_tokens, 0, pad_lens, dcache, d_cross,
        draft_cfg, compute_dtype)
    rows = torch.arange(b, device=dev)
    sot_logits = logits_all[rows, sot_idx]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech]

    def zeros():
        return torch.zeros((b, 1), dtype=torch.long, device=dev)

    # the first token: the sequential loop's first iteration
    t0, gl0, lse0 = _flat_rules(
        logits_all[:, -1:].float(), tables, zeros(), zeros(), zeros(),
        torch.full((b, 1), tb - 1, dtype=torch.long, device=dev))
    first = t0[:, 0]

    # one spare column: emits past a row's end land there (index write)
    buf = torch.full((b, sample_len + 1), eot, dtype=torch.long, device=dev)
    buf[:, 0] = first
    n = torch.ones((b,), dtype=torch.long, device=dev)  # first: unconsumed
    last = first
    penult = torch.zeros((b,), dtype=torch.long, device=dev)
    max_ts = torch.where(first >= tb, first, torch.full_like(first, tb - 1))
    sum_lp = (gl0 - lse0)[:, 0]
    done = first == eot
    t_mask = ((torch.arange(t_len, device=dev)[None, :] < p_max)
              & (torch.arange(t_len, device=dev)[None, :]
                 >= pad_lens[:, None]))
    d_mask = ((torch.arange(d_len, device=dev)[None, :] < p_max)
              & (torch.arange(d_len, device=dev)[None, :]
                 >= pad_lens[:, None]))
    tpos = dpos = p_max
    passes = 0
    ar_k1 = torch.arange(K + 1, device=dev)[None, :]
    ar_k = ar_k1[:, :K]

    def active_rows():
        return ~done & (n < sample_len)

    while passes < budget:
        active = active_rows()
        if not bool(active.any()):
            break
        # per-row sequence position of `last` (the next token consumed)
        pos_last = p_max - pad_lens + n - 1

        # ---- draft K tokens; the pass's draft slots valid meanwhile ----
        d_pass = d_mask.clone()
        d_pass[:, dpos: dpos + K] = True
        tok, prev, mts = last, penult, max_ts
        drafts = []
        for i in range(K):
            logits, dcache = decoder_forward(
                draft_params, tok[:, None], dpos + i, pad_lens, dcache,
                d_cross, draft_cfg, compute_dtype, pos_base=pos_last + i,
                slot_mask=d_pass)
            nxt = _flat_rules(logits.float(), tables, (n + i)[:, None],
                              tok[:, None], prev[:, None],
                              mts[:, None])[0][:, 0]
            mts = torch.where(nxt >= tb, torch.maximum(mts, nxt), mts)
            prev, tok = tok, nxt
            drafts.append(nxt)
        drafts = torch.stack(drafts, dim=1)                       # (B, K)

        # ---- verify: one target pass over [last, d_0 .. d_{K-1}] -------
        inputs = torch.cat([last[:, None], drafts], dim=1)       # (B, K+1)
        t_pass = t_mask.clone()
        t_pass[:, tpos: tpos + K + 1] = True
        logits, cache = decoder_forward(
            params, inputs, tpos, pad_lens, cache, cross_kv, cfg,
            compute_dtype, pos_base=pos_last, slot_mask=t_pass)

        # the rule trackers at each verify position j, from the known
        # draft prefix: what the sequential loop holds at position n+j
        n_j = n[:, None] + ar_k1
        penult_j = torch.cat([penult[:, None], inputs[:, :-1]], dim=1)
        ts_in = torch.where(inputs >= tb, inputs,
                            torch.full_like(inputs, tb - 1))
        mts_j = torch.cummax(torch.cat([max_ts[:, None], ts_in[:, 1:]],
                                       dim=1), dim=1).values
        targets, gl, lse = _flat_rules(logits.float(), tables, n_j, inputs,
                                       penult_j, mts_j)          # (B, K+1)

        # ---- acceptance, clipped at the first eot ----------------------
        match = drafts == targets[:, :K]
        m = torch.cumprod(match.to(torch.long), dim=1).sum(dim=1)
        eot_pos = _first_true(targets == eot, K + 1)
        emit_n = torch.where(
            active, torch.minimum(torch.minimum(m, eot_pos) + 1,
                                  sample_len - n),
            torch.zeros_like(n))                                  # (B,)

        # ---- emit targets[0 .. emit_n-1] at n .. n+emit_n-1 ------------
        emit_mask = ar_k1 < emit_n[:, None]
        cols = torch.where(emit_mask, n[:, None] + ar_k1,
                           torch.full_like(inputs, sample_len))
        buf.scatter_(1, cols.clamp(max=sample_len), targets)
        sum_lp = sum_lp + torch.where(emit_mask, gl - lse,
                                      torch.zeros_like(gl)).sum(dim=1)

        # trackers from the emitted tail
        lastpos = torch.clamp(emit_n - 1, min=0)[:, None]
        emitted = emit_n > 0
        new_last = torch.where(emitted,
                               targets.gather(1, lastpos)[:, 0], last)
        # the token before new_last: inputs[emit_n - 1] (the old last for
        # emit_n == 1)
        penult = torch.where(emitted, inputs.gather(1, lastpos)[:, 0],
                             penult)
        last = new_last
        emitted_ts = torch.where(emit_mask & (targets >= tb), targets,
                                 torch.full_like(targets, tb - 1))
        new_mts = torch.maximum(max_ts, emitted_ts.amax(dim=1))
        max_ts = torch.where(active, new_mts, max_ts)
        # done only where the eot was emitted, not cut by sample_len
        done = done | (active & (eot_pos < emit_n))
        n = n + emit_n

        # ---- slot validity after the pass: the consumed last and the
        # accepted drafts d_j, j < emit_n - 1; the rest is garbage -------
        keep_t = torch.cat([active[:, None],
                            (ar_k < (emit_n - 1)[:, None])
                            & active[:, None]], dim=1)            # (B, K+1)
        t_mask[:, tpos: tpos + K + 1] = keep_t
        d_mask[:, dpos: dpos + K] = keep_t[:, :K]
        tpos += K + 1
        dpos += K
        passes += 1

    # ---- phase 2: a sequential tail for the pass budget's stragglers:
    # each step consumes `last` in one slot (the verify pass with K=0) --
    while True:
        active = active_rows()
        if not bool(active.any()):
            break
        pos_last = p_max - pad_lens + n - 1
        t_pass = t_mask.clone()
        t_pass[:, tpos] = True
        logits, cache = decoder_forward(
            params, last[:, None], tpos, pad_lens, cache, cross_kv, cfg,
            compute_dtype, pos_base=pos_last, slot_mask=t_pass)
        tok, gl, lse = (z[:, 0] for z in _flat_rules(
            logits.float(), tables, n[:, None], last[:, None],
            penult[:, None], max_ts[:, None]))
        cols = torch.where(active, n, torch.full_like(n, sample_len))
        buf.scatter_(1, cols.clamp(max=sample_len)[:, None], tok[:, None])
        t_mask[:, tpos] = active
        max_ts = torch.where(active & (tok >= tb),
                             torch.maximum(max_ts, tok), max_ts)
        sum_lp = sum_lp + torch.where(active, gl - lse, torch.zeros_like(gl))
        done = done | (active & (tok == eot))
        penult = torch.where(active, last, penult)
        last = torch.where(active, tok, last)
        n = n + active.to(torch.long)
        tpos += 1
        passes += 1

    tokens = buf[:, :sample_len]
    n_sampled = torch.sum(tokens != eot, dim=1)
    return tokens, n_sampled, sum_lp, no_speech_prob, passes


def frames_encode_decode_speculative_impl(
    params, draft_params, frames, prompt_tokens, pad_lens, sot_idx, tables,
    cfg: WhisperConfig, draft_cfg: WhisperConfig, sample_len: int,
    k_draft: int, draft_pool: int, compute_dtype=torch.float32,
    xattn_bf16: bool = False, q8_kv: bool = False, self_draft: bool = True,
):
    """STFT frames -> mel -> encode -> speculative decode: the batcher's
    framed main path, speculative."""
    from ..audio.mel import log_mel_from_frames
    from ..models.whisper import encode
    mel = log_mel_from_frames(frames, n_mels=cfg.n_mels,
                              n_frames=2 * cfg.n_audio_ctx)
    return encode_decode_speculative_impl(
        params, draft_params, mel, prompt_tokens, pad_lens, sot_idx, tables,
        cfg, draft_cfg, sample_len, k_draft, draft_pool, compute_dtype,
        xattn_bf16, q8_kv, self_draft)


def encode_decode_speculative_impl(
    params, draft_params, mel, prompt_tokens, pad_lens, sot_idx, tables,
    cfg: WhisperConfig, draft_cfg: WhisperConfig, sample_len: int,
    k_draft: int, draft_pool: int, compute_dtype=torch.float32,
    xattn_bf16: bool = False, q8_kv: bool = False, self_draft: bool = True,
):
    """mel -> encode -> speculative decode (the batcher's mel-window
    path)."""
    from ..models.whisper import encode
    xa = encode(params, mel, cfg, compute_dtype=compute_dtype)
    return decode_window_speculative_impl(
        params, draft_params, xa, prompt_tokens, pad_lens, sot_idx, tables,
        cfg, draft_cfg, sample_len, k_draft, draft_pool, compute_dtype,
        xattn_bf16, q8_kv, self_draft)


def decode_window_speculative(
    params,
    xa: torch.Tensor,
    prompts: Sequence[Sequence[int]],
    cfg: WhisperConfig,
    tables: RuleTables,
    sample_len: Optional[int] = None,
    k_draft: int = 3,
    draft_pool: int = 4,
    draft_params=None,
    draft_cfg: Optional[WhisperConfig] = None,
    compute_dtype=torch.float32,
    xattn_bf16: bool = False,
    return_passes: bool = False,
):
    """Host wrapper mirroring ``decode_window`` (greedy only). With no
    ``draft_params`` the target drafts for itself over ``draft_pool`` x
    time-pooled cross-KV; with ``draft_params``/``draft_cfg`` a second
    model drafts (same tokenizer; it reads the target's encoder
    states)."""
    from .greedy import decode_window_finalize, pad_prompts

    dev = xa.device
    prompt_np, pad_np = pad_prompts(prompts, cfg.eot)
    p_max = prompt_np.shape[1]
    sot_np = np.array([pad_np[i] + list(p).index(cfg.sot)
                       for i, p in enumerate(prompts)], np.int64)
    sample_len = sample_len or cfg.n_text_ctx // 2
    sample_len = min(sample_len, cfg.n_text_ctx - p_max)
    tokens, n_sampled, sum_lp, nsp, passes = decode_window_speculative_impl(
        params, draft_params if draft_params is not None else params, xa,
        torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
        torch.as_tensor(pad_np, dtype=torch.long, device=dev),
        torch.as_tensor(sot_np, device=dev), tables.to(dev), cfg,
        draft_cfg if draft_cfg is not None else cfg, sample_len, k_draft,
        draft_pool, compute_dtype, xattn_bf16,
        self_draft=draft_params is None)
    out = decode_window_finalize(
        (tokens, n_sampled, sum_lp, nsp, np.zeros(len(prompts), np.float32)))
    if return_passes:
        return out, passes
    return out
