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
not only its finalize step, in the sacrificial thread. Greedy and
temperature sampling only; no mesh, no speculative decoding, no beam
strategy in this slice.
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
from ..decode.rules import (DecodeOptions, RuleTables, build_rule_tables,
                            check_supported)

log = logging.getLogger(__name__)


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


class WindowBatcher:
    """Background thread packing window-decode requests into batches."""

    def __init__(self, params, cfg: WhisperConfig, tokenizer=None,
                 opts: Optional[DecodeOptions] = None, max_batch: int = 8,
                 max_wait_ms: float = 5.0, compute_dtype=torch.float32,
                 device="cuda", seed: int = 0,
                 batch_deadline_s: Optional[float] = None):
        self.opts = opts or DecodeOptions()
        check_supported(self.opts)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.tables: RuleTables = build_rule_tables(
            cfg, self.opts, tokenizer, device=self.device)
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
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._running = True
        self.batch_sizes: List[int] = []    # observability
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="nwt-window-batcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, mel_window: Optional[np.ndarray], prompt: Sequence[int],
               temperature: float = 0.0, lang_slot: Optional[int] = None,
               frames: Optional[np.ndarray] = None) -> "Future":
        """Submit either a mel window or STFT ``frames``."""
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
                    else np.asarray(frames, np.float32))))
        return fut

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
            return torch.from_numpy(np.stack(framed)).to(dev), None
        # mixed framed and mel requests: framed rows get their mel here
        from ..audio.mel import log_mel_from_frames
        mels = iter(log_mel_from_frames(
            torch.from_numpy(np.stack(framed)).to(dev), n_mels=cfg.n_mels,
            n_frames=wf) if framed else [])
        rows = [next(mels) if r.frames is not None
                else torch.from_numpy(r.mel).to(dev) for r in batch]
        return None, torch.stack(rows)

    def _run_batch(self, batch: List[_Request]):
        from ..core.tokenizer import LANGUAGES
        from ..decode.greedy import (decode_window_dispatch,
                                     decode_window_finalize,
                                     frames_encode_detect_impl)
        from ..models.whisper import encode

        self.batch_sizes.append(len(batch))
        frames, mel = self._stack_rows(batch)
        prompts = [list(r.prompt) for r in batch]
        temps = np.asarray([r.temperature for r in batch], np.float32)
        langs: List[Optional[str]] = [None] * len(batch)
        common = dict(temperature=temps, generator=self.generator,
                      compute_dtype=self.compute_dtype)
        if any(r.lang_slot is not None for r in batch):
            # auto-language rows: one batched forward from <|sot|> detects
            # the languages, then each row's language token is patched
            if frames is not None:
                xa, lang_idx, _ = frames_encode_detect_impl(
                    self.params, frames, self.cfg, self.compute_dtype)
            else:
                from ..decode.greedy import detect_language
                xa = encode(self.params, mel, self.cfg, self.compute_dtype)
                lang_idx, _ = detect_language(self.params, xa, self.cfg,
                                              self.compute_dtype)
            lang_idx = lang_idx.cpu().numpy()
            for i, r in enumerate(batch):
                if r.lang_slot is not None:
                    prompts[i][r.lang_slot] = (self.cfg.lang_base
                                               + int(lang_idx[i]))
                    langs[i] = LANGUAGES[int(lang_idx[i])]
            handle = decode_window_dispatch(
                self.params, xa, prompts, self.cfg, self.tables, self.opts,
                **common)
        else:
            # fixed-language main path: frames -> mel -> encode -> decode
            handle = decode_window_dispatch(
                self.params, None, prompts, self.cfg, self.tables,
                self.opts, mel=mel, frames=frames, **common)
        for r, res, lang in zip(batch, decode_window_finalize(handle),
                                langs):
            res.language = lang
            if not r.future.done():
                r.future.set_result(res)
