"""Word-level timestamps: cross-attention alignment + DTW (port of
``decode/timing.py``).

A teacher-forced pass over the window's tokens collects the raw
cross-attention scores of the alignment heads; on the host they are
truncated to the window's real frames, softmaxed, standardized,
median-filtered and aligned to time by dynamic time warping, and the
path's boundaries give each word's start and end (openai-whisper's
method). Alignment heads default to every head of the upper half of the
decoder layers; a checkpoint's tuned list can be passed in.

The host NumPy parts are the reference's as they are (DTW's tie order is
part of the result). The teacher-forced pass runs every linear through
``models/whisper.py::_dense``, so it also takes int8 weights (dequantized
in the compute dtype, as the decoder's torch path does), where the
reference's plain ``@`` raises a ``TypeError`` on a quantized weight.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WhisperConfig

TIME_PRECISION = 0.02   # seconds per DTW column (2 mel frames)


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float
    tokens: List[int]
    probability: float


def default_alignment_heads(cfg: WhisperConfig) -> List[Tuple[int, int]]:
    """All heads of the upper half of decoder layers."""
    start = cfg.n_text_layer // 2
    return [(l, h) for l in range(start, cfg.n_text_layer)
            for h in range(cfg.n_text_head)]


@torch.inference_mode()
def _cross_attn_scores(params, tokens: torch.Tensor, xa: torch.Tensor,
                       cfg: WhisperConfig,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced full-sequence pass returning RAW (pre-softmax,
    scaled) cross-attention scores.

    tokens: (B, S); xa: (B, T_audio, d). Returns (L, B, H, S, T_audio)
    f32. The alignment needs raw scores: it truncates them to the
    window's real frames and softmaxes after, so padded-silence frames
    never absorb attention mass.

    The residual stream runs in ``compute_dtype`` and the encoder-state
    projections in xa's dtype; a plain weight takes its operand's dtype
    (the reference's type promotion), an int8 one is dequantized in it."""
    from ..models.whisper import (_attention, _const, _dense, _f32_dot,
                                  _gelu, _layer, _layer_norm, _merge_heads,
                                  _split_heads)
    from ..ops.quant import is_quantized

    def lin(h, w, bias=None):
        if not is_quantized(w):
            w = w.to(h.dtype)
            bias = None if bias is None else bias.to(h.dtype)
        return _dense(h, w, bias)

    dec = params["decoder"]
    n_head = cfg.n_text_head
    b, s = tokens.shape
    x = (dec["tok_emb"][tokens] + dec["pos"][:s]).to(compute_dtype)
    ar = torch.arange(s, device=tokens.device)
    causal = (ar[None, :] <= ar[:, None])[None, None]
    out = []
    for layer in range(cfg.n_text_layer):
        p = _layer(dec["blocks"], layer)
        h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
        q = _split_heads(lin(h, p["q_w"], p["q_b"]), n_head)
        k = _split_heads(lin(h, p["k_w"]), n_head)
        v = _split_heads(lin(h, p["v_w"], p["v_b"]), n_head)
        x = x + lin(_merge_heads(_attention(q, k, v, causal)),
                    p["o_w"], p["o_b"])
        h = _layer_norm(x, p["lnx_g"], p["lnx_b"])
        q = _split_heads(lin(h, p["xq_w"], p["xq_b"]), n_head)
        xk = _split_heads(lin(xa, p["xk_w"]), n_head)
        xv = _split_heads(lin(xa, p["xv_w"], p["xv_b"]), n_head)
        dh = q.shape[-1]
        scores = _f32_dot(q * _const(dh ** -0.25, q),
                          (xk * _const(dh ** -0.25, xk)).transpose(-1, -2))
        probs = torch.softmax(scores, dim=-1)
        a = _merge_heads(probs.to(xv.dtype) @ xv)
        x = x + lin(a, p["xo_w"], p["xo_b"])
        h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
        h = _gelu(lin(h, p["fc1_w"], p["fc1_b"]))
        x = x + lin(h, p["fc2_w"], p["fc2_b"])
        out.append(scores)
    return torch.stack(out)  # (L, B, H, S, T_audio)


def decoder_cross_attn_weights(params, tokens: torch.Tensor,
                               xa: torch.Tensor, cfg: WhisperConfig,
                               compute_dtype=torch.float32) -> torch.Tensor:
    """Cross-attention PROBS (softmax over the full audio axis): a
    diagnostic surface; the alignment path uses the raw scores."""
    return torch.softmax(
        _cross_attn_scores(params, tokens, xa, cfg, compute_dtype), dim=-1)


def alignment_scores(params, tokens: torch.Tensor, xa: torch.Tensor,
                     cfg: WhisperConfig, heads,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The word-timestamp attention pass with only the alignment heads'
    raw scores of batch row 0 selected on the device: (A, S, T_audio)
    f32, the only part that goes to the host."""
    scores = _cross_attn_scores(params, tokens, xa, cfg, compute_dtype)
    return torch.stack([scores[l, 0, h] for (l, h) in heads])


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (edge-padded)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a (N_tokens, N_frames) cost matrix.

    Returns (text_indices, time_indices) tracing the minimal-cost path with
    moves (i+1,j), (i,j+1), (i+1,j+1).

    Each row is a vectorized min-plus scan: the in-row recurrence
    ``acc[i,j] = cost[i-1,j-1] + min(cand[j], acc[i,j-1])`` with
    ``cand[j] = min(acc[i-1,j-1], acc[i-1,j])`` unrolls to ``acc[i,j] =
    C[j] + min_{k<=j}(cand[k] - C[k-1])`` where C is the prefix sum of the
    row's costs, a cumulative minimum; only the short token axis is a
    Python loop.
    """
    n, m = cost.shape
    cost = np.asarray(cost, np.float64)
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        c = np.cumsum(cost[i - 1])                       # C[j], j=1..m
        cand = np.minimum(acc[i - 1, :-1], acc[i - 1, 1:])   # cand[j]
        g = cand.copy()
        g[1:] -= c[:-1]                                  # cand[k] - C[k-1]
        acc[i, 1:] = c + np.minimum.accumulate(g)
    # backtrack; the move at each cell is reconstructed from acc with the
    # scalar dp's tie-break preference: diagonal, then down (advance
    # token), then right (advance time)
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            c0 = acc[i - 1, j - 1]   # diagonal
            c1 = acc[i - 1, j]       # down
            c2 = acc[i, j - 1]       # right
            if c0 <= c1 and c0 <= c2:
                i -= 1
                j -= 1
            elif c1 <= c2:
                i -= 1
            else:
                j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def split_tokens_on_spaces(tokenizer, tokens: Sequence[int]
                           ) -> Tuple[List[str], List[List[int]]]:
    """Group text tokens into whitespace-delimited words (unicode-safe:
    boundaries only where the accumulated bytes decode cleanly)."""
    words: List[str] = []
    word_tokens: List[List[int]] = []
    cur_tokens: List[int] = []
    cur_bytes = b""
    replacement = "�"

    def flush():
        nonlocal cur_tokens, cur_bytes
        if cur_tokens:
            words.append(cur_bytes.decode("utf-8", errors="replace"))
            word_tokens.append(cur_tokens)
            cur_tokens, cur_bytes = [], b""

    for tok in tokens:
        if tok >= tokenizer.eot:
            continue
        piece = tokenizer._vocab[tok]
        text = (cur_bytes + piece).decode("utf-8", errors="replace")
        starts_new = (piece.startswith(b" ") and cur_tokens
                      and replacement not in text)
        if starts_new:
            flush()
        cur_tokens.append(tok)
        cur_bytes += piece
    flush()
    return words, word_tokens


def find_word_timings(
    params,
    cfg: WhisperConfig,
    tokenizer,
    xa: torch.Tensor,             # (1, T_audio, d) for one window
    text_tokens: Sequence[int],   # sampled tokens (timestamps included ok)
    sot_sequence: Sequence[int],
    num_frames: int,              # real mel frames in this window
    time_offset: float = 0.0,
    alignment_heads: Optional[List[Tuple[int, int]]] = None,
    token_probs: Optional[Sequence[float]] = None,
    medfilt_width: int = 7,
) -> List[WordTiming]:
    """Align one window's tokens to time and group them into words."""
    clean = [t for t in text_tokens if t < tokenizer.eot]
    if not clean:
        return []
    full = list(sot_sequence) + clean + [tokenizer.eot]
    tokens_t = torch.tensor([full], dtype=torch.long, device=xa.device)

    heads = tuple(alignment_heads or default_alignment_heads(cfg))
    w = alignment_scores(params, tokens_t, xa, cfg,
                         heads).cpu().numpy()                # (A, S, T)
    # truncate the RAW scores to the window's real frames, THEN softmax:
    # padded-silence frames never hold attention mass
    w = w[:, :, : num_frames // 2]
    w = w - w.max(axis=-1, keepdims=True)
    w = np.exp(w)
    w = w / w.sum(axis=-1, keepdims=True)

    # per-head standardization over time, then smoothing
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True) + 1e-8
    w = (w - mean) / std
    w = median_filter(w, medfilt_width)
    matrix = w.mean(axis=0)                    # (S, T')
    # rows = the text tokens PLUS the eot row: the eot's first DTW frame
    # anchors the last word's end where speech stops, not at the window end
    matrix = matrix[len(sot_sequence): len(sot_sequence) + len(clean) + 1]

    text_idx, time_idx = dtw_path(-matrix.astype(np.float64))

    # token boundaries: the first time index of each token; each matrix
    # column = 2 mel frames = one 20 ms timestamp step
    jumps = np.diff(text_idx, prepend=-1) > 0
    bounds = time_idx[jumps] * TIME_PRECISION  # len(clean) + 1 entries
    start_times = bounds[:-1]
    end_times = bounds[1:]

    words, word_toks = split_tokens_on_spaces(tokenizer, clean)
    out: List[WordTiming] = []
    cursor = 0
    for word, toks in zip(words, word_toks):
        n = len(toks)
        s_idx = cursor
        e_idx = cursor + n - 1
        cursor += n
        if s_idx >= len(start_times):
            break
        start = float(start_times[s_idx])
        end = float(end_times[min(e_idx, len(end_times) - 1)])
        prob = 1.0
        if token_probs is not None:
            ps = [token_probs[i] for i in range(s_idx, min(e_idx + 1,
                                                           len(token_probs)))]
            prob = float(np.mean(ps)) if ps else 1.0
        out.append(WordTiming(word=word, start=time_offset + start,
                              end=time_offset + end, tokens=toks,
                              probability=prob))
    return out


_SENTENCE_END_MARKS = ".。!！?？"


def refine_word_durations(words: List[WordTiming]) -> None:
    """openai-whisper's word-anchor duration heuristics, in place: words
    are clamped to twice the window's median word duration at sentence
    boundaries, and an anomalously long FIRST word (a leading pause
    absorbed into it) is truncated from its end."""
    if not words:
        return
    durations = [max(w.end - w.start, 0.0) for w in words]
    med = float(np.median(durations)) if durations else 0.0
    max_dur = med * 2 if med > 0 else 0.0
    if max_dur <= 0:
        return
    for i, w in enumerate(words):
        if w.end - w.start > max_dur:
            if w.word.strip() in _SENTENCE_END_MARKS:
                w.end = w.start + max_dur
            elif i > 0 and words[i - 1].word.strip() in _SENTENCE_END_MARKS:
                w.start = w.end - max_dur
    if words[0].end - words[0].start > max_dur:
        words[0].start = max(words[0].end - max_dur, 0.0)


def refine_segments_with_words(segments, words: List[WordTiming],
                               window_end: float) -> None:
    """Snap segment bounds to their words' anchors, in place: each
    segment's start becomes its first word's start and its end its last
    word's end, clamped monotonic and inside the window. Segments without
    words keep their timestamp-rule bounds."""
    prev_end = None
    for seg in segments:
        ws = seg.words if getattr(seg, "words", None) else None
        if ws:
            start = ws[0].start
            end = max(ws[-1].end, start)
            if prev_end is not None:
                start = max(start, prev_end)
                end = max(end, start)
            seg.start = start
            seg.end = min(end, window_end) if window_end > 0 else end
        prev_end = seg.end


def merge_punctuations(words: List[WordTiming],
                       prepended: str = "\"'“¿([{-",
                       appended: str = "\"'.。,，!！?？:：”)]}、") -> None:
    """Fold leading/trailing punctuation into neighboring words (in place),
    as openai-whisper merges them."""
    i = len(words) - 2
    j = len(words) - 1
    while i >= 0:
        prev, nxt = words[i], words[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            nxt.word = prev.word + nxt.word
            nxt.tokens = prev.tokens + nxt.tokens
            nxt.start = prev.start
            prev.word = ""
            prev.tokens = []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(words):
        prev, nxt = words[i], words[j]
        if not prev.word.endswith(" ") and nxt.word in appended:
            prev.word = prev.word + nxt.word
            prev.tokens = prev.tokens + nxt.tokens
            prev.end = nxt.end
            nxt.word = ""
            nxt.tokens = []
        else:
            i = j
        j += 1
    words[:] = [w for w in words if w.word]
