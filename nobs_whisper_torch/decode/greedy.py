"""Batched window decode: greedy and temperature sampling (port of
``decode/greedy.py``).

The reference runs prefill, the per-step logits, rules, sampling and stop
handling as one jitted device program with a ``lax.while_loop``. PyTorch
runs eagerly, so here the step loop is a Python loop over device tensors
that exits early once every row is done (checked every ``_EXIT_CHECK``
steps, one host sync each; rows that are done keep emitting eot and do not
change the result). Ragged batches are left-padded; sampling draws from an
explicit ``torch.Generator``.

A step updates the loop's state in place and reads its position from a
step counter on the device (:class:`_DecodeLoop`), so on the card a greedy
batch captures one step as a CUDA graph after its prefill and replays it
for every later step but the last (:class:`_StepGraph`): the host's
enqueue of the step's thousands of kernels becomes one launch. Sampling rungs (their ``torch.Generator``), tp shards, the
mesh's shards and the CPU run the same step eagerly.

Inside a batch of the window batcher each stage adds its host time to the
batch's record (``utils/profiling.py::batch_record``): ``encode``,
``prefill``, ``capture``, a step's ``forward`` (or replay) and ``rules``,
``sync`` where the host waits on the device, ``finalize``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WhisperConfig
from ..core.device import scalar
from ..models.whisper import (decoder_forward, init_kv_cache,
                              precompute_cross_kv, precompute_cross_kv_q8,
                              xattn_kernel_enabled)
from ..ops import _build
from ..ops.attention_pallas import pack_cross_kv_bf16, quantize_cross_kv
from ..parallel import tp as _tp
from ..utils.profiling import BatchRecord, RoutingTrace, batch_record
from .rules import (NEG_INF, DecodeOptions, RuleTables,
                    apply_logit_rules_scored, build_rule_tables)

_EXIT_CHECK = 8


def kt_xattn_default(compute_dtype) -> bool:
    """Packed (Dh, T) cross-K layout, read at each call as the reference
    reads it (decode/greedy.py:29-46), with the card in the TPU's place:
    ``NWT_NO_KT_XATTN`` opts out, ``NWT_FORCE_KT`` forces it at any
    compute dtype, otherwise on at bf16 (the serving path) and off at f32."""
    if os.environ.get("NWT_NO_KT_XATTN"):
        return False
    if os.environ.get("NWT_FORCE_KT"):
        return True
    return compute_dtype == torch.bfloat16


@dataclasses.dataclass
class WindowResult:
    """Per-batch-element outcome of one 30 s window decode."""

    tokens: List[int]            # sampled tokens, eot stripped
    sum_logprob: float           # includes the stop token's logprob
    avg_logprob: float           # sum / (n_text_tokens + 1)
    no_speech_prob: float
    temperature: float
    language: Optional[str] = None   # set when the batcher auto-detected
    # (layers, positions, top_k) int8: the experts each position of the
    # prompt and the served tokens fed back chose, for a model with
    # experts (utils/profiling.py::RoutingTrace), else None
    routing: Optional[np.ndarray] = None


class WindowHandle(NamedTuple):
    """What a window program's dispatch leaves on the device for
    :func:`decode_window_finalize`: each row's tokens, count, summed
    log-probability, no-speech probability and temperature; ``passes``
    the pass count of an exact speculative batch; ``routing`` the batch's
    routing on a model with experts (``utils/profiling.py::
    RoutingTrace``)."""
    tokens: torch.Tensor
    n_sampled: torch.Tensor
    sum_logprob: torch.Tensor
    no_speech_prob: torch.Tensor
    temperatures: np.ndarray
    passes: Optional[torch.Tensor] = None
    routing: Optional[RoutingTrace] = None


def _pad_len(n: int) -> int:
    """Quantize prompt pad length (the reference's recompile bound; kept
    so prompts pad identically); above 256 (a speech LM's prompts, never
    Whisper's) the next multiple of 64."""
    for p in (8, 32, 64, 128, 256):
        if n <= p:
            return p
    return -(-n // 64) * 64


def pad_prompts(prompts: Sequence[Sequence[int]],
                eot: int) -> Tuple[np.ndarray, np.ndarray]:
    """LEFT-pad ragged prompts with eot -> (tokens (B, P_max), pad_lens)."""
    lens = np.array([len(p) for p in prompts], np.int32)
    p_max = _pad_len(int(lens.max()))
    out = np.full((len(prompts), p_max), eot, np.int32)
    for i, p in enumerate(prompts):
        out[i, p_max - len(p):] = p
    return out, (p_max - lens).astype(np.int32)


def _sample(masked: torch.Tensor, temperature: torch.Tensor,
            generator: torch.Generator) -> torch.Tensor:
    """Per-row categorical draw from softmax(masked / t) (Gumbel-max)."""
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    u = torch.rand(masked.shape, generator=generator,
                   device=masked.device).clamp_(min=1e-20, max=1.0 - 1e-7)
    return torch.argmax(masked / temp - torch.log(-torch.log(u)), dim=-1)


def window_cross_kv(params, xa: torch.Tensor, cfg: WhisperConfig,
                    q8_kv: bool, xattn_bf16: bool, raw=None):
    """The decode loop's cross-KV: int8 with ``q8_kv`` (projected and
    quantized one layer at a time unless ``raw``, the projected K/V, is
    given), else packed bf16 with ``xattn_bf16``, else plain."""
    if q8_kv:
        if raw is not None:
            return quantize_cross_kv(raw)
        return precompute_cross_kv_q8(params, xa, cfg)
    if raw is None:
        raw = precompute_cross_kv(params, xa, cfg)
    if not xattn_bf16:
        return raw
    kT, v = pack_cross_kv_bf16(raw)
    if not xattn_kernel_enabled():
        # without K4 (which reads bf16) the scores/PV run on f32 copies of
        # the bf16 values, made once per window instead of once per step
        return {"kT": kT["kT"].float()}, {"v": v["v"].float()}
    return kT, v


class _DecodeLoop:
    """The sampling loop's state on the device, updated in place by every
    step so that a captured step replays on it: the next token's f32
    ``logits`` (B, V); ``step``, the step counter (the step's n_sampled,
    its column of ``tokens`` and, past the prompt, its cache position);
    the sampled ``tokens`` (B, sample_len) and their ``sum_logprob``; the
    rows that are ``done``; the last, second-to-last and highest timestamp
    tokens. ``forward(tokens (B, 1), cache_start)`` runs the decoder."""

    def __init__(self, logits: torch.Tensor, tables: RuleTables,
                 temperature: torch.Tensor,
                 generator: Optional[torch.Generator], sampling: bool,
                 sample_len: int, p_max: int, forward: Callable):
        b, dev = logits.shape[0], logits.device
        self.tables, self.temperature = tables, temperature
        self.generator, self.sampling = generator, sampling
        self._state(logits, tables.eot, sample_len, p_max, forward)
        self.max_ts = torch.full((b,), tables.timestamp_begin - 1,
                                 dtype=torch.long, device=dev)
        self.last = torch.zeros((b,), dtype=torch.long, device=dev)
        self.penult = torch.zeros((b,), dtype=torch.long, device=dev)

    def _state(self, logits: torch.Tensor, eot: int, sample_len: int,
               p_max: int, forward: Callable) -> None:
        b, dev = logits.shape[0], logits.device
        self.p_max, self._forward = p_max, forward
        self.logits = logits
        self.step = torch.zeros((), dtype=torch.long, device=dev)
        self.tokens = torch.full((b, sample_len), eot, dtype=torch.long,
                                 device=dev)
        self.sum_logprob = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.eot = scalar(eot, torch.long, dev)

    def rules(self) -> torch.Tensor:
        """The step's logit rules, its tokens (greedy, or sampled for rows
        above temperature 0) and the state's updates; returns the tokens
        (B,)."""
        b = self.logits.shape[0]
        tb = self.tables.timestamp_begin
        masked, lse, greedy_logit = apply_logit_rules_scored(
            self.logits, self.tables, n_sampled=self.step.expand(b),
            last_token=self.last, penult_token=self.penult,
            max_ts_token=self.max_ts)
        greedy_tok = torch.argmax(masked, dim=-1)
        if self.sampling:
            sampled = _sample(masked, self.temperature, self.generator)
            tok = torch.where(self.temperature > 0, sampled, greedy_tok)
            tok_logit = torch.gather(masked, 1, tok[:, None])[:, 0]
        else:
            tok, tok_logit = greedy_tok, greedy_logit
        done = self.done
        tok = torch.where(done, self.eot, tok)
        self.sum_logprob += torch.where(done, 0.0, tok_logit - lse)
        self.tokens.scatter_(1, self.step.expand(b, 1), tok[:, None])
        self.max_ts.copy_(torch.where((tok >= tb) & ~done,
                                      torch.maximum(self.max_ts, tok),
                                      self.max_ts))
        self.penult.copy_(torch.where(done, self.penult, self.last))
        self.last.copy_(torch.where(done, self.last, tok))
        done |= tok == self.eot
        return tok

    def forward(self, tok: torch.Tensor) -> None:
        """The next token's logits from the step's tokens; the counter
        moves on."""
        logits = self._forward(tok[:, None], self.step + self.p_max)
        self.logits.copy_(logits[:, 0])
        self.step += 1


class _StopLoop(_DecodeLoop):
    """The loop of a model without Whisper's rules: plain greedy over the
    logits; a row is done at any of ``stop_ids`` and then emits ``eot``."""

    def __init__(self, logits: torch.Tensor, eot: int, stop_ids, sample_len:
                 int, p_max: int, forward: Callable):
        self._state(logits, eot, sample_len, p_max, forward)
        self.stop = torch.tensor(list(stop_ids), dtype=torch.long,
                                 device=logits.device)

    def rules(self) -> torch.Tensor:
        b = self.logits.shape[0]
        tok = torch.argmax(self.logits, dim=-1)
        tok_logit = torch.gather(self.logits, 1, tok[:, None])[:, 0]
        lse = torch.logsumexp(self.logits, dim=-1)
        done = self.done
        tok = torch.where(done, self.eot, tok)
        self.sum_logprob += torch.where(done, 0.0, tok_logit - lse)
        self.tokens.scatter_(1, self.step.expand(b, 1), tok[:, None])
        done |= (tok[:, None] == self.stop).any(dim=1)
        return tok


class _Captures:
    """A device's captures: they take turns (``lock``) on one ``stream``
    and allocate the step's temporaries from one memory ``pool``. The
    graphs replay on the batches' stream one after another, and no replay
    leaves anything in the pool for the next. A pool lives while a graph
    captured into it does, so the ``last`` graph is kept."""

    def __init__(self, dev: torch.device):
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.last: Optional[torch.cuda.CUDAGraph] = None


_CAPTURES: Dict[torch.device, _Captures] = {}
_CAPTURES_LOCK = threading.Lock()


def _captures(dev: torch.device) -> _Captures:
    with _CAPTURES_LOCK:
        if dev not in _CAPTURES:
            _CAPTURES[dev] = _Captures(dev)
        return _CAPTURES[dev]


class _StepGraph:
    """A decode step captured as a CUDA graph: the rules, the greedy
    choice, the state's updates and the next token's ``decoder_forward``,
    on the batch's own cache, cross-KV and loop state. Captured once a
    batch (a capture enqueues nothing); each :meth:`replay` runs the step
    on the batch's current stream and counts the launches it replays
    (``ops/_build.py::count``)."""

    def __init__(self, step: Callable[[], None], dev: torch.device):
        cap = _captures(dev)
        self.graph = torch.cuda.CUDAGraph()
        self.launches = _build.LaunchTally()
        # thread_local: each batch runs in a thread of its own, and other
        # threads keep working on the card during the capture
        with cap.lock, self.launches, torch.cuda.device(dev), \
                torch.cuda.stream(cap.stream):
            self.graph.capture_begin(pool=cap.pool,
                                     capture_error_mode="thread_local")
            try:
                step()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
            cap.last = self.graph

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replay()


@torch.inference_mode()
def decode_window_impl(params, xa: torch.Tensor, prompt_tokens: torch.Tensor,
                       pad_lens: torch.Tensor, sot_idx: torch.Tensor,
                       tables: RuleTables, temperature: torch.Tensor,
                       generator: Optional[torch.Generator],
                       cfg: WhisperConfig, sample_len: int,
                       compute_dtype=torch.float32, q8_kv: bool = False,
                       xattn_bf16: bool = False, sampling: bool = True,
                       cuda_graph: bool = True):
    """Returns (tokens (B, sample_len), n_sampled (B,), sum_logprob (B,),
    no_speech_prob (B,)), all device tensors; the cross-KV layout is
    :func:`window_cross_kv`'s. The steps replay a CUDA graph of one step
    on a CUDA device, at tp size 1, without ``sampling`` and with
    ``cuda_graph`` (False: the mesh's shards, and a test's eager run)."""
    rec, t = batch_record(), time.time_ns()
    b, p_max = prompt_tokens.shape
    dev = xa.device
    cross_kv = window_cross_kv(params, xa, cfg, q8_kv, xattn_bf16)
    t = rec.add("encode", t)
    t_cache = -(-(p_max + sample_len) // 8) * 8
    cache = init_kv_cache(cfg, b, dtype=compute_dtype,
                          t_ctx=min(t_cache, cfg.n_text_ctx), device=dev)

    def forward(tokens, cache_start):
        return decoder_forward(params, tokens, cache_start, pad_lens, cache,
                               cross_kv, cfg, compute_dtype)[0]

    logits_all = forward(prompt_tokens, 0)
    sot_logits = logits_all[torch.arange(b, device=dev), sot_idx]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech]
    loop = _DecodeLoop(logits_all[:, -1].clone(), tables,
                       temperature, generator, sampling, sample_len, p_max,
                       forward)
    del logits_all
    use_graph = (cuda_graph and not sampling and dev.type == "cuda"
                 and _tp.tp_size() == 1)
    t = rec.add("prefill", t)
    run_steps(loop, sample_len, use_graph, dev, rec, t)
    n_sampled = torch.sum(loop.tokens != tables.eot, dim=1)
    return loop.tokens, n_sampled, loop.sum_logprob, no_speech_prob


def run_steps(loop: _DecodeLoop, sample_len: int, use_graph: bool,
              dev: torch.device, rec, t: int) -> None:
    """The loop's steps: an exit check every ``_EXIT_CHECK``, the last
    step's rules alone, the others eagerly or, with ``use_graph``, as
    replays of one step captured at the first."""
    graph = None
    for step in range(sample_len):
        if step and step % _EXIT_CHECK == 0:
            finished = bool(loop.done.all())
            t = rec.add("sync", t)
            if finished:
                break
        if step + 1 == sample_len:          # the last token needs no forward
            loop.rules()
            t = rec.add("rules", t)
        elif use_graph:
            if graph is None:
                # a constant is made at its first use, which the capture
                # may not hold: the prefill made the decoder's
                scalar(NEG_INF, loop.logits.dtype, dev)
                graph = _StepGraph(lambda: loop.forward(loop.rules()), dev)
                t = rec.add("capture", t)
            graph.replay()
            t = rec.replayed(t)
        else:
            tok = loop.rules()
            t = rec.add("rules", t)
            loop.forward(tok)
            t = rec.add("forward", t)


def frames_encode_decode_window_impl(
    params, frames, prompt_tokens, pad_lens, sot_idx, tables, temperature,
    generator, cfg, sample_len, compute_dtype=torch.float32, q8_kv=False,
    xattn_bf16=False, sampling=True, cuda_graph=True,
):
    """STFT-framed audio -> mel -> encoder -> decode loop: the serving
    main path (frames from ``audio/mel.py::frame_window_np``)."""
    from ..audio.mel import log_mel_from_frames
    from ..models.whisper import encode
    t = time.time_ns()
    mel = log_mel_from_frames(frames, n_mels=cfg.n_mels,
                              n_frames=2 * cfg.n_audio_ctx)
    xa = encode(params, mel, cfg, compute_dtype=compute_dtype)
    batch_record().add("encode", t)
    return decode_window_impl(params, xa, prompt_tokens, pad_lens, sot_idx,
                              tables, temperature, generator, cfg,
                              sample_len, compute_dtype, q8_kv,
                              xattn_bf16, sampling, cuda_graph=cuda_graph)


def decode_window_dispatch(
    params,
    xa: Optional[torch.Tensor],
    prompts: Sequence[Sequence[int]],
    cfg: WhisperConfig,
    tables: RuleTables,
    opts: DecodeOptions,
    temperature=0.0,             # scalar or per-element sequence
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
    mel: Optional[torch.Tensor] = None,     # fuse encode
    frames: Optional[torch.Tensor] = None,  # fuse mel + encode
    speculative: int = 0,        # K > 0: exact speculative greedy
    draft_pool: int = 4,
    draft=None,                  # (draft_params, draft_cfg); None = self
    mesh=None,                   # parallel/mesh.py::Mesh: dp x tp serving
):
    """Pad prompts and run the window decode; returns the handle that
    :func:`decode_window_finalize` scores. Exactly one of ``xa``, ``mel``
    and ``frames`` is given.

    With ``speculative`` K > 0 (or ``opts.speculative``; the explicit
    argument wins, as does an explicit ``draft_pool`` other than 4) and
    every row at temperature 0, the batch decodes by exact speculative
    greedy (``decode/speculative.py``) and the handle carries the pass
    count; rows above temperature 0 (ladder rungs) take the sampling
    loop.

    With a ``mesh`` the batch (its size a multiple of dp; the batcher pads
    it) is padded once here and then sharded: each dp group runs the
    single-device program on its rows (``parallel/spmd.py``), over its tp
    ranks when tp > 1. ``params`` may be the unsharded tree or
    ``parallel/mesh.py::shard_params``'s. Speculative decoding on a mesh
    self-drafts (``draft`` is ignored, as in the reference's mesh
    program) and its handle has no pass count."""
    t = time.time_ns()
    n = len(prompts)
    speculative = speculative or opts.speculative
    if draft_pool == 4 and opts.draft_pool != 4:
        draft_pool = opts.draft_pool
    src = next(z for z in (frames, mel, xa) if z is not None)
    dev = src.device
    prompt_np, pad_np = pad_prompts(prompts, cfg.eot)
    p_max = prompt_np.shape[1]
    sot_np = np.array([pad_np[i] + list(p).index(cfg.sot)
                       for i, p in enumerate(prompts)], np.int64)
    sample_len = opts.sample_len or cfg.n_text_ctx // 2
    sample_len = min(sample_len, cfg.n_text_ctx - p_max)
    temps = np.broadcast_to(np.asarray(temperature, np.float32),
                            (n,)).copy()
    sampling = bool(np.any(temps > 0))
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xattn_bf16 = (opts.xattn_bf16 or bool(os.environ.get("NWT_XATTN_BF16"))
                  or kt_xattn_default(compute_dtype))
    if mesh is not None:
        from ..parallel.spmd import window_decode_spmd
        kind, data = (("frames", frames) if frames is not None
                      else ("mel", mel) if mel is not None else ("xa", xa))
        out = window_decode_spmd(
            params, data, torch.as_tensor(prompt_np, dtype=torch.long),
            torch.as_tensor(pad_np, dtype=torch.long),
            torch.as_tensor(sot_np), tables, torch.as_tensor(temps),
            generator, mesh, cfg, sample_len, compute_dtype,
            q8_kv=opts.q8_cross_kv, xattn_bf16=xattn_bf16,
            sampling=sampling, kind=kind, speculative=speculative,
            draft_pool=draft_pool)
        return WindowHandle(*out, temps)
    if speculative > 0 and not sampling:
        from . import speculative as sp
        d_params, d_cfg = draft if draft is not None else (params, cfg)
        common = (torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
                  torch.as_tensor(pad_np, dtype=torch.long, device=dev),
                  torch.as_tensor(sot_np, device=dev), tables.to(dev), cfg,
                  d_cfg, sample_len, speculative, draft_pool, compute_dtype,
                  xattn_bf16, opts.q8_cross_kv, draft is None)
        if frames is not None:
            out = sp.frames_encode_decode_speculative_impl(
                params, d_params, frames, *common)
        elif mel is not None:
            out = sp.encode_decode_speculative_impl(params, d_params, mel,
                                                    *common)
        else:
            out = sp.decode_window_speculative_impl(params, d_params, xa,
                                                    *common)
        tokens, n_sampled, sum_lp, nsp, passes = out
        return WindowHandle(tokens, n_sampled, sum_lp, nsp, temps, passes)
    args = (torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
            torch.as_tensor(pad_np, dtype=torch.long, device=dev),
            torch.as_tensor(sot_np, device=dev), tables.to(dev),
            torch.as_tensor(temps, device=dev), generator, cfg, sample_len,
            compute_dtype, opts.q8_cross_kv, xattn_bf16, sampling)
    rec = batch_record()
    t = rec.add("prefill", t)
    if frames is not None:
        out = frames_encode_decode_window_impl(params, frames, *args)
    else:
        if mel is not None:
            from ..models.whisper import encode
            xa = encode(params, mel, cfg, compute_dtype=compute_dtype)
            rec.add("encode", t)
        out = decode_window_impl(params, xa, *args)
    return WindowHandle(*out, temps)


class WindowProgram:
    """A model's window program as ``pipeline/batcher.py::WindowBatcher``
    runs it: the logit rule tables its decode takes (None: it has none)
    and the dispatch that decodes a batch of windows into a
    :class:`WindowHandle`, with :func:`decode_window_dispatch`'s
    arguments. Whisper's: ``build_rule_tables`` and
    :func:`decode_window_dispatch`; the engine names its model's
    (``api.py``: ``window_program``)."""

    @staticmethod
    def rule_tables(cfg, opts: DecodeOptions, tokenizer,
                    device) -> Optional[RuleTables]:
        return build_rule_tables(cfg, opts, tokenizer, device=device)

    @staticmethod
    def dispatch(*args, **kwargs) -> WindowHandle:
        return decode_window_dispatch(*args, **kwargs)


WHISPER_WINDOW = WindowProgram()


def decode_window_finalize(handle: WindowHandle) -> List[WindowResult]:
    """Copy the decode's device tensors to the host and score them."""
    rec, t = batch_record(), time.time_ns()
    tokens, n_sampled, sum_lp, nsp, temps, _, trace = handle
    tokens = tokens.cpu().numpy()
    n_sampled = n_sampled.cpu().numpy()
    sum_lp = sum_lp.cpu().numpy()
    nsp = nsp.float().cpu().numpy()
    routing = None if trace is None else trace.routing.cpu().numpy()
    t = rec.add("sync", t)
    out = []
    for i in range(tokens.shape[0]):
        toks = tokens[i, : n_sampled[i]].tolist()
        out.append(WindowResult(
            tokens=toks,
            sum_logprob=float(sum_lp[i]),
            avg_logprob=float(sum_lp[i]) / (len(toks) + 1),
            no_speech_prob=float(nsp[i]),
            temperature=float(temps[i]),
            routing=(None if trace is None
                     else trace.row(routing, i, len(toks))),
        ))
    if trace is not None and isinstance(rec, BatchRecord):
        rec.experts = trace.counts(routing)
    rec.add("finalize", t)
    return out


def decode_window(params, xa, prompts, cfg, tables, opts, temperature=0.0,
                  generator=None, compute_dtype=torch.float32, mel=None
                  ) -> List[WindowResult]:
    """Host wrapper: pad prompts, run the decode loop, score results."""
    return decode_window_finalize(decode_window_dispatch(
        params, xa, prompts, cfg, tables, opts, temperature, generator,
        compute_dtype, mel))


# ---------------------------------------------------------------------------
# language detection
# ---------------------------------------------------------------------------

@torch.inference_mode()
def detect_language(params, xa: torch.Tensor, cfg: WhisperConfig,
                    compute_dtype=torch.float32):
    """Single forward from [sot]: softmax over the language tokens.
    Returns (lang_idx (B,), lang_probs (B, n_langs))."""
    b = xa.shape[0]
    dev = xa.device
    cross_kv = precompute_cross_kv(params, xa, cfg)
    cache = init_kv_cache(cfg, b, dtype=compute_dtype, t_ctx=8, device=dev)
    sot = torch.full((b, 1), cfg.sot, dtype=torch.long, device=dev)
    logits, _ = decoder_forward(params, sot, 0,
                                torch.zeros((b,), dtype=torch.long,
                                            device=dev),
                                cache, cross_kv, cfg, compute_dtype)
    logits = logits[:, 0]
    lo, hi = cfg.lang_base, cfg.lang_base + cfg.n_langs
    masked = torch.full_like(logits, -1e30)
    masked[:, lo:hi] = logits[:, lo:hi]
    lang_probs = torch.softmax(masked, dim=-1)[:, lo:hi]
    return torch.argmax(lang_probs, dim=-1), lang_probs


def frames_encode_impl(params, frames, cfg: WhisperConfig,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """STFT frames -> mel -> encoder states, without language detection:
    the beam batcher's fixed-language batches need the encoder states but
    no detect forward."""
    from ..audio.mel import log_mel_from_frames
    from ..models.whisper import encode
    mel = log_mel_from_frames(frames, n_mels=cfg.n_mels,
                              n_frames=2 * cfg.n_audio_ctx)
    return encode(params, mel, cfg, compute_dtype=compute_dtype)


def frames_encode_detect_impl(params, frames, cfg: WhisperConfig,
                              compute_dtype=torch.float32):
    """STFT frames -> mel -> encoder states + detected languages. Returns
    (xa, lang_idx, lang_probs); xa feeds decode_window_dispatch."""
    xa = frames_encode_impl(params, frames, cfg, compute_dtype)
    lang_idx, lang_probs = detect_language(params, xa, cfg, compute_dtype)
    return xa, lang_idx, lang_probs


def frames_encode_dispatch(params, frames, cfg: WhisperConfig,
                           compute_dtype=torch.float32, mesh=None):
    """Mesh-aware frames -> mel -> encode stage (no detect): on a mesh each
    dp group encodes its rows (``parallel/spmd.py``)."""
    if mesh is not None:
        from ..parallel.spmd import frames_encode_spmd
        return frames_encode_spmd(params, frames, mesh, cfg, compute_dtype)
    return frames_encode_impl(params, frames, cfg, compute_dtype)


def frames_encode_detect_dispatch(params, frames, cfg: WhisperConfig,
                                  compute_dtype=torch.float32, mesh=None):
    """Mesh-aware frames -> mel -> encode -> detect stage, as
    :func:`decode_window_dispatch` is for the decode stage: callers pass
    ``mesh=`` and never branch on it themselves."""
    if mesh is not None:
        from ..parallel.spmd import frames_encode_detect_spmd
        return frames_encode_detect_spmd(params, frames, mesh, cfg,
                                         compute_dtype)
    return frames_encode_detect_impl(params, frames, cfg, compute_dtype)
