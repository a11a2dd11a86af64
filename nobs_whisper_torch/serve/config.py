"""Persistent JSON app config with forward-compatible defaults.

Behavioral port of the reference's config system (src-tauri/src/config.rs):
a single JSON document at a well-known path, every field defaulted so old
configs load after upgrades (config.rs:26-33), created on first load
(config.rs:82-86), written through on change, and ``set_config`` applying
side effects — model hot-swap when the selection changes (config.rs:138-164).
Hotkey/shortcut fields map to server-trigger settings in the serving build.

Port of the JAX package's ``serve/config.py``. The home directory
(``NOBS_WHISPER_TPU_HOME``, else ``$XDG_CONFIG_HOME/nobs-whisper-tpu``) and
its layout are the JAX package's, so one user's config and downloaded
models serve both packages.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

# reference default custom vocabulary: dev-tool terms (config.rs:40-42)
DEFAULT_VOCABULARY = (
    "GitHub, VSCode, Python, JavaScript, TypeScript, Rust, Docker, "
    "Kubernetes, API, JSON, YAML, CLI, SDK, npm, cargo, git, pull request, "
    "merge, commit, deploy, backend, frontend, database, async, struct, "
    "enum, trait, impl, tokio, React, Svelte, Tauri"
)


@dataclasses.dataclass
class AppConfig:
    selected_model: Optional[str] = None
    language: str = "auto"                 # auto | ko | en | ja | zh | ...
    max_recording_duration: int = 60       # seconds; 0 = unlimited (<=600)
    custom_vocabulary: str = DEFAULT_VOCABULARY
    push_to_talk: bool = False
    # serving-layer additions (replace hotkey/indicator config)
    host: str = "127.0.0.1"
    port: int = 8777
    batch_window: int = 8                  # windows batched across sessions
    compute_dtype: str = "bfloat16"
    # decode strategy (the reference pins Greedy{best_of:1} at
    # whisper.rs:88; the engine capability includes beam + the
    # temperature ladder — exposed here so the serving layer can choose,
    # and overridable per session via POST /sessions)
    beam_size: int = 1                     # >1 = beam search at temp 0
    best_of: int = 1                       # >1 = best-of sampling at t>0
    temperature: float = 0.0
    task: str = "transcribe"               # transcribe | translate

    @classmethod
    def _fields(cls) -> Dict[str, Any]:
        return {f.name: f for f in dataclasses.fields(cls)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AppConfig":
        """Unknown keys ignored, missing keys defaulted — old and new
        configs both load (serde #[serde(default)] semantics)."""
        known = cls._fields()
        kwargs = {k: v for k, v in d.items() if k in known}
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def config_dir() -> Path:
    base = os.environ.get("NOBS_WHISPER_TPU_HOME")
    if base:
        return Path(base)
    xdg = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    return Path(xdg) / "nobs-whisper-tpu"


def config_path() -> Path:
    return config_dir() / "config.json"


def models_dir() -> Path:
    d = config_dir() / "models"
    d.mkdir(parents=True, exist_ok=True)
    return d


def load_config() -> AppConfig:
    path = config_path()
    if not path.exists():
        cfg = AppConfig()
        save_config(cfg)  # created on first load
        return cfg
    try:
        with open(path) as f:
            return AppConfig.from_dict(json.load(f))
    except (json.JSONDecodeError, TypeError):
        log.warning("corrupt config at %s; using defaults", path)
        return AppConfig()


def save_config(cfg: AppConfig) -> None:
    path = config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    os.replace(tmp, path)


class ConfigManager:
    """Holds the live config and applies set-config side effects."""

    def __init__(self, engine_provider=None):
        self.config = load_config()
        self._engine_provider = engine_provider  # callable(model_id) -> None
        # serializes concurrent set_config calls: an engine rebuild takes
        # minutes, and two racing POSTs must not leave the live engine
        # disagreeing with the persisted selected_model
        self._lock = threading.RLock()

    def set_engine_provider(self, provider) -> bool:
        """Install the hot-swap hook (public seam for the serving layer).
        Refuses to displace a provider installed at construction time;
        returns whether ``provider`` is now active."""
        with self._lock:
            if self._engine_provider is None:
                self._engine_provider = provider
            return self._engine_provider is provider

    def set_config(self, new: AppConfig) -> None:
        if new.task not in ("transcribe", "translate"):
            raise ValueError(
                f"unknown task {new.task!r}; have transcribe, translate")
        with self._lock:
            old = self.config
            # side effect FIRST: hot-swap the model if the selection
            # changed (config.rs:138-164). Running the provider before
            # persisting keeps config and engine in agreement when the
            # swap fails (model not downloaded, load error): nothing is
            # saved, the caller sees the error, and re-POSTing the same
            # selection retries the swap instead of short-circuiting on
            # "unchanged".
            if (new.selected_model != old.selected_model
                    and self._engine_provider is not None
                    and new.selected_model):
                log.info("model selection changed %s -> %s; hot-swapping",
                         old.selected_model, new.selected_model)
                self._engine_provider(new.selected_model)
            save_config(new)
            self.config = new

    def update(self, **changes) -> AppConfig:
        self.set_config(dataclasses.replace(self.config, **changes))
        return self.config
