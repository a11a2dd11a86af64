"""Cross-session window batcher (port of ``pipeline/batcher.py``).

Concurrent callers' 30 s windows are packed into one decode batch (the
left-padded ragged decoder handles differing prompts). A background thread
collects requests for up to ``max_wait_ms`` (or until ``max_batch``), runs
the batch and resolves each caller's future.

Differences from the reference, all because PyTorch runs eagerly: batches
are not padded to a power of two and frame rows are padded only to the
longest row of the batch (there is no compile cache to bound), and a batch
runs to completion before the next is collected (the decode loop syncs
with the card for its early exit, so there is no asynchronous dispatch to
overlap). For the same reason the batch watchdog runs the whole batch,
not only its finalize step, in the sacrificial thread.

Each request carries its submit stamp and the time its caller spent
preparing it; each batch leaves a record of its host time by part
on ``utils/profiling.py::GLOBAL_PROFILER`` (``/stats`` and the benchmark
read them).

With a ``mesh`` (``parallel/mesh.py``: dp x tp) the parameters are
sharded once, here, and every batch is padded to a multiple of dp by
replicating a real row, then split over the dp groups, each running the
single-device program on its rows (``parallel/spmd.py``), over its tp
ranks when tp > 1. ``max_batch`` must divide by dp.

With ``speculative`` K > 0 (or ``NWT_SPECULATIVE``) every batch whose
rows are all at temperature 0 decodes by exact speculative greedy, with
the target drafting for itself over ``draft_pool`` x pooled cross-KV or
with a second model (``draft``); ``spec_stats`` records each such batch
for ``/stats``.

With ``opts.beam_size`` > 1 the batcher takes the beam strategy, as the
reference: the batch is encoded (with one language-detect forward only if
a row asks for auto language), then its rows at temperature 0 decode by
beam search and its rows above 0 (ladder retries) by sampling, two calls
for a mixed batch. Where the reference pads each subset to its bounded
batch sizes (a new size compiles a new program), each subset here runs at
its own size, as every batch of this batcher does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.config import WhisperConfig
from ..decode.rules import DecodeOptions, RuleTables
from ..utils.profiling import GLOBAL_PROFILER

log = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        log.warning("ignoring malformed %s=%r", name, os.environ.get(name))
        return default


def submit_timeout_s() -> float:
    """Submit-side future timeout for callers blocking on results."""
    return float(os.environ.get("NWT_BATCH_DEADLINE_S", 900.0)) + 120.0


@dataclasses.dataclass
class _Request:
    mel: Optional[np.ndarray]   # (n_mels, 2*n_audio_ctx), or None
    prompt: List[int]
    future: Future
    temperature: float = 0.0
    # index into prompt whose token is replaced by the detected language
    lang_slot: Optional[int] = None
    # STFT-framed audio (n <= N_FRAMES, N_FFT): the fused main path
    frames: Optional[np.ndarray] = None
    t_submit: int = 0           # time.time_ns() at submit
    prep_ns: int = 0            # the caller's preparation before submit


class WindowBatcher:
    """Background thread packing window-decode requests into batches."""

    def __init__(self, params, cfg: WhisperConfig, tokenizer=None,
                 opts: Optional[DecodeOptions] = None, max_batch: int = 8,
                 max_wait_ms: float = 5.0, compute_dtype=torch.float32,
                 device="cuda", seed: int = 0,
                 batch_deadline_s: Optional[float] = None,
                 speculative: int = 0, draft_pool: Optional[int] = None,
                 draft=None, mesh=None, program=None):
        """``program``: the model's window program (``decode/greedy.py::
        WindowProgram``'s surface: its rule tables and its dispatch; the
        engine's ``window_program``), default Whisper's.
        ``speculative``/``draft_pool``: an explicit value wins over
        ``NWT_SPECULATIVE``/``NWT_DRAFT_POOL``, which only fill the
        defaults; a malformed value is logged and ignored. ``draft``:
        (draft_params, draft_cfg) of a second-model draft, which must
        share the vocabulary and the encoder width (it reads the target's
        encoder states). ``mesh``: a ``parallel/mesh.py::Mesh``; the
        batcher then runs on its devices (``device`` is not used), and a
        second-model draft is dropped with a warning (mesh serving
        self-drafts, as the reference's)."""
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import shard_params
            dp = mesh.shape["dp"]
            if max_batch % dp != 0:
                raise ValueError(f"max_batch ({max_batch}) must be "
                                 f"divisible by dp ({dp})")
            if draft is not None:
                log.warning("mesh serving self-drafts; the configured "
                            "second-model draft is ignored under a mesh")
                draft = None
            params = shard_params(params, mesh)
            device = mesh.first
        self.opts = opts or DecodeOptions()
        self.speculative = (speculative if speculative
                            else _env_int("NWT_SPECULATIVE", 0))
        self.draft_pool = (draft_pool if draft_pool is not None
                           else _env_int("NWT_DRAFT_POOL", 4))
        if draft is not None:
            d_cfg = draft[1]
            if (d_cfg.n_vocab != cfg.n_vocab
                    or d_cfg.n_audio_state != cfg.n_audio_state):
                raise ValueError(
                    f"draft model incompatible: vocab {d_cfg.n_vocab} vs "
                    f"{cfg.n_vocab}, encoder width {d_cfg.n_audio_state} "
                    f"vs {cfg.n_audio_state}")
        self.draft = draft
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        if program is None:
            from ..decode.greedy import WHISPER_WINDOW as program
        self.program = program
        self.tables: Optional[RuleTables] = program.rule_tables(
            cfg, self.opts, tokenizer, self.device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.compute_dtype = compute_dtype
        # temperature > 0 rows sample from this generator (one per batcher)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # watchdog deadline for one batch: at it the batch's futures fail
        # and the batcher goes on serving (the reference's default)
        if batch_deadline_s is None:
            batch_deadline_s = float(
                os.environ.get("NWT_BATCH_DEADLINE_S", 900.0))
        self.batch_deadline_s = batch_deadline_s
        self.watchdog_trips = 0             # observability
        # host->device payload bytes (frames / mel rows) since start:
        # /stats observability
        self.transferred_bytes: int = 0
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._running = True
        self.batch_sizes: List[int] = []    # observability
        self.spec_stats: List[tuple] = []   # (passes, rows, emitted)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="nwt-window-batcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, mel_window: Optional[np.ndarray], prompt: Sequence[int],
               temperature: float = 0.0, lang_slot: Optional[int] = None,
               frames: Optional[np.ndarray] = None,
               prep_ns: int = 0) -> "Future":
        """Submit either a mel window or STFT ``frames``; ``prep_ns``: the
        caller's time preparing the request (framing, prompt), for its
        batch's record."""
        t_submit = time.time_ns()
        if (mel_window is None) == (frames is None):
            raise ValueError("pass exactly one of mel_window / frames")
        if not self._running:
            raise RuntimeError("batcher closed")
        fut: Future = Future()
        self._q.put(_Request(
            mel=(None if mel_window is None
                 else np.asarray(mel_window, np.float32)),
            prompt=list(prompt), future=fut,
            temperature=float(temperature), lang_slot=lang_slot,
            frames=(None if frames is None
                    else np.asarray(frames, np.float32)),
            t_submit=t_submit, prep_ns=prep_ns))
        return fut

    def warmup(self, auto_language: bool = True,
               timeout_s: float = 3600.0) -> List[int]:
        """Push one silent 30 s window batch of each size {1, 2, 4, ...,
        max_batch} through the production ``submit`` path before live
        traffic. PyTorch compiles nothing, so where the reference warms
        one compiled program per padded size and frame bucket, this builds
        the card's kernels and the encoder's K-major weight copies on the
        first batch, and runs each size's allocations once.
        ``auto_language`` also sends one batch of the largest size through
        the language-detection path (a multilingual model's default).
        Returns the sizes warmed."""
        if self.tokenizer is None:
            raise ValueError("warmup needs the batcher's tokenizer")
        cfg = self.cfg
        from ..audio.mel import frame_window_np
        wf = 2 * cfg.n_audio_ctx
        frames = frame_window_np(np.zeros(wf * 160, np.float32),
                                 n_frames=wf)
        sizes, k = [], 1
        while k < self.max_batch:
            sizes.append(k)
            k *= 2
        sizes.append(self.max_batch)
        lang = "en" if cfg.multilingual else None
        prompt = self.tokenizer.sot_sequence(language=lang,
                                             task=self.opts.task)
        runs = [(n, None) for n in sizes]
        if auto_language and cfg.multilingual:
            runs.append((self.max_batch, 1))   # lang token after <|sot|>
        # the collector can wake mid-submission and split a group into
        # two smaller batches: retry a size it never ran, once
        for attempt in range(2):
            todo = runs if attempt == 0 else [
                (n, slot) for n, slot in runs if slot is None
                and n not in self.batch_sizes]
            for n, slot in todo:
                futs = [self.submit(None, prompt, lang_slot=slot,
                                    frames=frames) for _ in range(n)]
                for f in futs:
                    f.result(timeout=timeout_s)
        log.info("batcher warmup ran sizes %s", sizes)
        return sizes

    def close(self):
        self._running = False
        self._q.put(None)
        self._thread.join(timeout=60)

    # ------------------------------------------------------------------
    def _collect(self) -> List[_Request]:
        """Block for one request, then sweep whatever arrives within the
        batching window (or until max_batch)."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # propagate shutdown after this batch
                break
            batch.append(nxt)
        return batch

    def _loop(self):
        """Shutdown is sentinel-driven: requests submitted before close()
        are still decoded and delivered."""
        while True:
            batch = self._collect()
            if not batch:
                break
            self._run_watched(batch)
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.future.done():
                r.future.set_exception(RuntimeError("batcher closed"))

    def _run_watched(self, batch: List[_Request]):
        """Run one batch in a sacrificial daemon thread under the
        deadline. A batch that never returns fails its futures with
        ``TimeoutError`` and is abandoned; an exception fails them with
        itself. Either way the loop goes on to the next batch."""
        done = threading.Event()
        err: List[BaseException] = []

        def run():
            try:
                self._run_batch(batch)
            except BaseException as e:
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name="nwt-batch-run").start()
        if not done.wait(self.batch_deadline_s):
            self.watchdog_trips += 1
            log.error("batch of %d not finished after %.0fs; failing its "
                      "futures and continuing", len(batch),
                      self.batch_deadline_s)
            e: BaseException = TimeoutError(
                f"window batch result not ready after "
                f"{self.batch_deadline_s:.0f}s (wedged device dispatch)")
        elif err:
            log.error("batch decode failed", exc_info=err[0])
            e = err[0]
        else:
            return
        for r in batch:
            if not r.future.done():
                r.future.set_exception(e)

    def _stack_rows(self, batch: List[_Request]):
        """(frames, mel): one of them a stacked device batch."""
        dev, cfg = self.device, self.cfg
        wf = 2 * cfg.n_audio_ctx
        framed = [r.frames for r in batch if r.frames is not None]
        if framed:
            n = max(f.shape[0] for f in framed)
            if n > wf:
                raise ValueError(
                    f"frames row has {n} rows > the engine window ({wf}); "
                    "frame with n_frames=2*cfg.n_audio_ctx")
            framed = [np.concatenate([f, np.zeros((n - f.shape[0],
                                                   f.shape[1]), np.float32)])
                      if f.shape[0] < n else f for f in framed]
        if len(framed) == len(batch):
            stacked = np.stack(framed)
            self.transferred_bytes += stacked.nbytes
            return torch.from_numpy(stacked).to(dev), None
        # mixed framed and mel requests: framed rows get their mel here
        from ..audio.mel import log_mel_from_frames
        self.transferred_bytes += sum(f.nbytes for f in framed) + sum(
            r.mel.nbytes for r in batch if r.frames is None)
        mels = iter(log_mel_from_frames(
            torch.from_numpy(np.stack(framed)).to(dev), n_mels=cfg.n_mels,
            n_frames=wf) if framed else [])
        rows = [next(mels) if r.frames is not None
                else torch.from_numpy(r.mel).to(dev) for r in batch]
        return None, torch.stack(rows)

    def _run_batch(self, batch: List[_Request]):
        """Decode one batch under its record (published before the
        futures resolve), then resolve the futures."""
        self.batch_sizes.append(len(batch))
        with GLOBAL_PROFILER.batch([(r.t_submit, r.prep_ns)
                                    for r in batch]) as rec:
            results, langs = self._decode_batch(batch, rec)
        for r, res, lang in zip(batch, results, langs):
            res.language = lang
            if res.routing is not None:
                GLOBAL_PROFILER.keep_routing(r.prompt, res.tokens,
                                             res.routing)
            if not r.future.done():
                r.future.set_result(res)

    def _decode_batch(self, batch: List[_Request], rec):
        """(results, languages) of the batch's rows; ``rec`` its record."""
        from ..core.tokenizer import LANGUAGES
        from ..decode import greedy
        from ..models.whisper import encode

        if self.mesh is not None:
            # pad to at least dp rows and a multiple of dp by replicating
            # a real row; the padding rows' results go to futures nobody
            # holds
            dp = self.mesh.shape["dp"]
            n_pad = max(len(batch), dp)
            n_pad += -n_pad % dp
            batch = batch + [dataclasses.replace(batch[0], future=Future())
                             for _ in range(n_pad - len(batch))]
        frames, mel = self._stack_rows(batch)
        t = rec.add("stack", rec.start_ns)
        prompts = [list(r.prompt) for r in batch]
        temps = np.asarray([r.temperature for r in batch], np.float32)
        langs: List[Optional[str]] = [None] * len(batch)
        need_lang = any(r.lang_slot is not None for r in batch)
        use_beam = (self.opts.beam_size or 0) > 1
        if need_lang or use_beam:
            # auto-language rows: one batched forward from <|sot|> detects
            # the languages, then each row's language token is patched; a
            # fixed-language beam batch needs the encoder states only
            if frames is not None and need_lang:
                xa, lang_idx, _ = greedy.frames_encode_detect_dispatch(
                    self.params, frames, self.cfg, self.compute_dtype,
                    mesh=self.mesh)
            elif frames is not None:
                xa = greedy.frames_encode_dispatch(
                    self.params, frames, self.cfg, self.compute_dtype,
                    mesh=self.mesh)
            elif self.mesh is not None:
                from ..parallel import spmd
                xa = spmd.encode_spmd(self.params, mel, self.mesh, self.cfg,
                                      self.compute_dtype)
                if need_lang:
                    lang_idx, _ = spmd.detect_language_spmd(
                        self.params, xa, self.mesh, self.cfg,
                        self.compute_dtype)
            else:
                xa = encode(self.params, mel, self.cfg, self.compute_dtype)
                if need_lang:
                    lang_idx, _ = greedy.detect_language(
                        self.params, xa, self.cfg, self.compute_dtype)
            t = rec.add("encode", t)
            if need_lang:
                lang_idx = lang_idx.cpu().numpy()
                rec.add("sync", t)
                for i, r in enumerate(batch):
                    if r.lang_slot is not None:
                        prompts[i][r.lang_slot] = (self.cfg.lang_base
                                                   + int(lang_idx[i]))
                        langs[i] = LANGUAGES[int(lang_idx[i])]
            if use_beam and self.mesh is not None:
                from ..parallel.spmd import run_on_mesh, shard_seeds
                seeds = shard_seeds(self.generator, self.mesh.shape["dp"])
                results = run_on_mesh(
                    self.mesh, self.params,
                    lambda p, x, pr, t, seed: self._beam_results(
                        x, pr, t, params=p, generator=torch.Generator(
                            device=x.device).manual_seed(seed[0])),
                    (xa, prompts, temps, seeds))
            elif use_beam:
                results = self._beam_results(xa, prompts, temps)
            else:
                results = self._finalize(self.program.dispatch(
                    self.params, xa, prompts, self.cfg, self.tables,
                    self.opts, temperature=temps, generator=self.generator,
                    compute_dtype=self.compute_dtype, **self._spec_kw()))
        else:
            # fixed-language main path: frames -> mel -> encode -> decode
            results = self._finalize(self.program.dispatch(
                self.params, None, prompts, self.cfg, self.tables,
                self.opts, temperature=temps, generator=self.generator,
                compute_dtype=self.compute_dtype, mel=mel, frames=frames,
                **self._spec_kw()))
        return results, langs

    def _spec_kw(self) -> dict:
        return dict(speculative=self.speculative,
                    draft_pool=self.draft_pool, draft=self.draft,
                    mesh=self.mesh)

    def _finalize(self, handle) -> list:
        """Score a decode handle; a speculative batch's (passes, rows,
        emitted tokens incl. each row's stop token) goes to
        ``spec_stats``."""
        from ..decode.greedy import decode_window_finalize
        results = decode_window_finalize(handle)
        if handle.passes is not None:
            emitted = sum(len(r.tokens) + 1 for r in results)
            self.spec_stats.append((int(handle.passes), len(results),
                                    emitted))
            del self.spec_stats[:-200]
        return results

    def _beam_results(self, xa: torch.Tensor, prompts: List[List[int]],
                      temps: np.ndarray, params=None,
                      generator: Optional[torch.Generator] = None) -> list:
        """The beam strategy's decode of one encoded batch: rows at
        temperature 0 by beam search, rows above it (ladder retries) by
        sampling (openai/whisper.cpp: beam at zero temperature, sampling
        above it); a mixed batch makes two calls, each subset at its own
        size. On a mesh each dp group runs this on its rows, with its own
        ``params`` and sampling ``generator``."""
        params = self.params if params is None else params
        generator = self.generator if generator is None else generator
        from ..decode.beam import beam_decode_window
        from ..decode.greedy import decode_window
        results: list = [None] * len(prompts)
        zero = [i for i, t in enumerate(temps) if t == 0]
        hot = [i for i, t in enumerate(temps) if t != 0]
        if zero:
            sub = beam_decode_window(
                params, xa[zero], [prompts[i] for i in zero], self.cfg,
                self.tables.to(xa.device), beam_size=self.opts.beam_size,
                sample_len=self.opts.sample_len,
                compute_dtype=self.compute_dtype)
            for i, r in zip(zero, sub):
                results[i] = r
        if hot:
            sub = decode_window(
                params, xa[hot], [prompts[i] for i in hot], self.cfg,
                self.tables.to(xa.device), self.opts,
                temperature=temps[hot], generator=generator,
                compute_dtype=self.compute_dtype)
            for i, r in zip(hot, sub):
                results[i] = r
        return results
