"""Model registry and download manager.

Behavioral port of the reference's model management
(src-tauri/src/model.rs): the 12-entry GGML registry (same ids, sizes,
categories, HuggingFace URLs), disk-status listing (model.rs:208-221),
streaming downloads with byte-accurate progress % (model.rs:293-318), a
duplicate-download guard (model.rs:237-241), partial-file cleanup on failure
(model.rs:287), and delete (model.rs:327-338). Pure stdlib (urllib +
threads) in place of reqwest/tokio. Port of the JAX package's
``serve/models.py``: the same registry, stored under the same home
directory (``serve/config.py::models_dir``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

from .config import models_dir

log = logging.getLogger(__name__)

_HF_CPP = "https://huggingface.co/ggerganov/whisper.cpp/resolve/main"
_HF_DISTIL = "https://huggingface.co/distil-whisper"


@dataclasses.dataclass
class ModelInfo:
    id: str
    name: str
    size: int
    description: str
    category: str
    url: str
    status: str = "not_downloaded"       # not_downloaded|downloading|downloaded
    download_progress: Optional[float] = None
    local_path: Optional[str] = None


def available_models() -> List[ModelInfo]:
    """The reference registry (model.rs:50-188), verbatim semantics."""
    def m(id, name, size, desc, cat, url):
        return ModelInfo(id=id, name=name, size=size, description=desc,
                         category=cat, url=url)

    return [
        m("tiny", "Tiny", 75_000_000,
          "Fastest, lowest accuracy (~75MB)", "Official",
          f"{_HF_CPP}/ggml-tiny.bin"),
        m("base", "Base", 150_000_000,
          "Fast, basic accuracy (~150MB)", "Official",
          f"{_HF_CPP}/ggml-base.bin"),
        m("small", "Small", 500_000_000,
          "Balanced performance (Recommended, ~500MB)", "Official",
          f"{_HF_CPP}/ggml-small.bin"),
        m("medium", "Medium", 1_500_000_000,
          "High accuracy (~1.5GB)", "Official",
          f"{_HF_CPP}/ggml-medium.bin"),
        m("large-v3", "Large V3", 3_000_000_000,
          "Best accuracy (~3GB)", "Official",
          f"{_HF_CPP}/ggml-large-v3.bin"),
        m("large-v3-turbo", "Large V3 Turbo", 1_600_000_000,
          "Fast Large model (~1.6GB)", "Official",
          f"{_HF_CPP}/ggml-large-v3-turbo.bin"),
        m("distil-small.en", "Distil Small (EN)", 340_000_000,
          "6x faster than small, English-only (~340MB)", "Distil-Whisper",
          f"{_HF_DISTIL}/distil-small.en/resolve/main/"
          "ggml-distil-small.en.bin"),
        m("distil-medium.en", "Distil Medium (EN)", 770_000_000,
          "6x faster than medium, English-only (~770MB)", "Distil-Whisper",
          f"{_HF_DISTIL}/distil-medium.en/resolve/main/"
          "ggml-distil-medium.en.bin"),
        m("distil-large-v3", "Distil Large V3", 1_500_000_000,
          "5x faster than large-v3, multilingual (~1.5GB)", "Distil-Whisper",
          f"{_HF_DISTIL}/distil-large-v3/resolve/main/"
          "ggml-distil-large-v3.bin"),
        m("small-q5_1", "Small Q5_1", 190_000_000,
          "Quantized small, 60% smaller (~190MB)", "Quantized",
          f"{_HF_CPP}/ggml-small-q5_1.bin"),
        m("medium-q5_0", "Medium Q5_0", 540_000_000,
          "Quantized medium, 65% smaller (~540MB)", "Quantized",
          f"{_HF_CPP}/ggml-medium-q5_0.bin"),
        m("large-v3-q5_0", "Large V3 Q5_0", 1_100_000_000,
          "Quantized large-v3, 65% smaller (~1.1GB)", "Quantized",
          f"{_HF_CPP}/ggml-large-v3-q5_0.bin"),
    ]


def model_path(model_id: str, base: Optional[Path] = None) -> Path:
    models = {m.id: m for m in available_models()}
    if model_id not in models:
        raise KeyError(f"unknown model {model_id!r}")
    filename = models[model_id].url.rsplit("/", 1)[-1]
    return (base or models_dir()) / filename


# global progress map guarded by a lock (the reference's
# DOWNLOAD_PROGRESS LazyLock<Mutex<HashMap>>, model.rs:47-48)
_PROGRESS: Dict[str, float] = {}
_ERRORS: Dict[str, str] = {}    # last failure per model id (cleared on
                                # the next attempt / success) — without
                                # it a failed download is
                                # indistinguishable from a finished one
_PROGRESS_LOCK = threading.Lock()


def get_download_progress(model_id: str) -> Optional[float]:
    with _PROGRESS_LOCK:
        return _PROGRESS.get(model_id)


def get_download_error(model_id: str) -> "Optional[str]":
    with _PROGRESS_LOCK:
        return _ERRORS.get(model_id)


def list_models(base: Optional[Path] = None) -> List[ModelInfo]:
    """Registry with per-model disk status."""
    out = []
    for m in available_models():
        path = model_path(m.id, base)
        prog = get_download_progress(m.id)
        if prog is not None:
            m.status = "downloading"
            m.download_progress = prog
        elif path.exists():
            m.status = "downloaded"
            m.local_path = str(path)
        out.append(m)
    return out


def download_model(model_id: str, base: Optional[Path] = None,
                   chunk_size: int = 1 << 20,
                   _opener=None) -> Path:
    """Streaming download with progress. Raises on failure after removing
    the partial file. ``_opener`` is injectable for tests (zero-egress CI).
    """
    import urllib.request

    models = {m.id: m for m in available_models()}
    if model_id not in models:
        raise KeyError(f"unknown model {model_id!r}")

    with _PROGRESS_LOCK:
        if model_id in _PROGRESS:
            raise RuntimeError(f"{model_id} is already downloading")
        _PROGRESS[model_id] = 0.0
        _ERRORS.pop(model_id, None)

    # everything after the progress entry registers must sit inside the
    # try/finally, or a failure (e.g. an unwritable models dir) leaves
    # the model stuck 'downloading' until process restart
    tmp = None
    opener = _opener or (lambda url: urllib.request.urlopen(url, timeout=60))
    try:
        path = model_path(model_id, base)
        tmp = path.with_suffix(".bin.partial")
        resp = opener(models[model_id].url)
        try:
            total = int(resp.headers.get("Content-Length", 0) or
                        models[model_id].size)
            done = 0
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(tmp, "wb") as f:
                while True:
                    buf = resp.read(chunk_size)
                    if not buf:
                        break
                    f.write(buf)
                    done += len(buf)
                    with _PROGRESS_LOCK:
                        _PROGRESS[model_id] = min(
                            100.0 * done / max(total, 1), 100.0)
        finally:
            # close the HTTP response on every path (injected test
            # openers may omit close(), hence the getattr)
            getattr(resp, "close", lambda: None)()
        os.replace(tmp, path)
        return path
    except Exception as e:
        if tmp is not None:
            tmp.unlink(missing_ok=True)  # partial-file cleanup
        with _PROGRESS_LOCK:
            _ERRORS[model_id] = str(e)
        raise
    finally:
        with _PROGRESS_LOCK:
            _PROGRESS.pop(model_id, None)


def delete_model(model_id: str, base: Optional[Path] = None) -> bool:
    path = model_path(model_id, base)
    if path.exists():
        path.unlink()
        return True
    return False
