"""Serving layer: config persistence/migration, model registry/downloads."""

import io
import json
import threading

import pytest
import torch

from nobs_whisper_torch.serve import models as mdl
from nobs_whisper_torch.serve.config import (
    DEFAULT_VOCABULARY, AppConfig, ConfigManager, config_path, load_config,
    save_config)

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores


@pytest.fixture(autouse=True)
def isolated_home(tmp_path, monkeypatch):
    monkeypatch.setenv("NOBS_WHISPER_TPU_HOME", str(tmp_path))
    yield tmp_path


# ---------------------------------------------------------------------------
# config (config.rs semantics)
# ---------------------------------------------------------------------------

def test_defaults():
    cfg = AppConfig()
    assert cfg.language == "auto"
    assert cfg.max_recording_duration == 60
    assert cfg.push_to_talk is False
    assert "GitHub" in DEFAULT_VOCABULARY
    assert cfg.custom_vocabulary == DEFAULT_VOCABULARY


def test_created_on_first_load(isolated_home):
    assert not config_path().exists()
    cfg = load_config()
    assert config_path().exists()
    assert cfg == AppConfig()


def test_roundtrip_and_migration(isolated_home):
    save_config(AppConfig(selected_model="small", language="ko"))
    loaded = load_config()
    assert loaded.selected_model == "small"
    assert loaded.language == "ko"

    # forward-compat: unknown keys ignored, missing keys defaulted
    with open(config_path(), "w") as f:
        json.dump({"selected_model": "tiny", "some_future_field": 42}, f)
    loaded = load_config()
    assert loaded.selected_model == "tiny"
    assert loaded.language == "auto"


def test_corrupt_config_falls_back(isolated_home):
    config_path().parent.mkdir(parents=True, exist_ok=True)
    config_path().write_text("{not json")
    assert load_config() == AppConfig()


def test_set_config_hot_swaps_model(isolated_home):
    swaps = []
    mgr = ConfigManager(engine_provider=swaps.append)
    mgr.update(selected_model="base")
    assert swaps == ["base"]
    mgr.update(language="ja")          # unrelated change: no swap
    assert swaps == ["base"]
    mgr.update(selected_model="small")
    assert swaps == ["base", "small"]
    # persisted
    assert load_config().selected_model == "small"


def test_set_config_swap_failure_not_persisted(isolated_home):
    """A failed hot-swap (model not downloaded, load error) must leave
    config and engine in agreement: nothing persisted, and re-POSTing
    the same selection retries the swap instead of short-circuiting on
    'unchanged' (config.rs:138-164 applies side effects before relying
    on the new selection)."""
    calls = []

    def provider(model_id):
        calls.append(model_id)
        if len(calls) == 1:
            raise RuntimeError("model not downloaded")

    mgr = ConfigManager(engine_provider=provider)
    with pytest.raises(RuntimeError):
        mgr.update(selected_model="base")
    assert mgr.config.selected_model is None       # live config unchanged
    assert load_config().selected_model is None    # nothing persisted
    # retry succeeds and persists
    mgr.update(selected_model="base")
    assert calls == ["base", "base"]
    assert mgr.config.selected_model == "base"
    assert load_config().selected_model == "base"


def test_set_engine_provider_public_seam(isolated_home):
    mgr = ConfigManager()
    swaps = []
    assert mgr.set_engine_provider(swaps.append)
    # an installed provider is not displaced
    assert not mgr.set_engine_provider(lambda m: None)
    mgr.update(selected_model="base")
    assert swaps == ["base"]


# ---------------------------------------------------------------------------
# model registry (model.rs semantics)
# ---------------------------------------------------------------------------

def test_registry_has_twelve_models():
    models = mdl.available_models()
    assert len(models) == 12
    ids = {m.id for m in models}
    assert ids == {
        "tiny", "base", "small", "medium", "large-v3", "large-v3-turbo",
        "distil-small.en", "distil-medium.en", "distil-large-v3",
        "small-q5_1", "medium-q5_0", "large-v3-q5_0"}
    cats = {m.category for m in models}
    assert cats == {"Official", "Distil-Whisper", "Quantized"}
    for m in models:
        assert m.url.startswith("https://huggingface.co/")
        assert m.size > 0


def test_model_path_naming(tmp_path):
    p = mdl.model_path("tiny", tmp_path)
    assert p.name == "ggml-tiny.bin"
    p = mdl.model_path("distil-large-v3", tmp_path)
    assert p.name == "ggml-distil-large-v3.bin"
    with pytest.raises(KeyError):
        mdl.model_path("nope", tmp_path)


class FakeResponse:
    def __init__(self, data, fail_after=None):
        self._buf = io.BytesIO(data)
        self.headers = {"Content-Length": str(len(data))}
        self._fail_after = fail_after
        self._read = 0

    def read(self, n):
        if self._fail_after is not None and self._read >= self._fail_after:
            raise IOError("connection reset")
        out = self._buf.read(n)
        self._read += len(out)
        return out


def test_download_with_progress(tmp_path):
    payload = b"x" * 10_000
    path = mdl.download_model(
        "tiny", tmp_path, chunk_size=1000,
        _opener=lambda url: FakeResponse(payload))
    assert path.exists()
    assert path.read_bytes() == payload
    assert mdl.get_download_progress("tiny") is None  # cleared after


def test_download_failure_cleans_partial(tmp_path):
    payload = b"y" * 10_000
    with pytest.raises(IOError):
        mdl.download_model(
            "base", tmp_path, chunk_size=1000,
            _opener=lambda url: FakeResponse(payload, fail_after=3000))
    assert not mdl.model_path("base", tmp_path).exists()
    assert not list(tmp_path.glob("*.partial"))
    assert mdl.get_download_progress("base") is None
    # a failure must be distinguishable from a silent completion
    # (model.rs has no such signal; clients polled into the void)
    assert mdl.get_download_error("base")
    # ...and the next attempt clears it
    mdl.download_model("base", tmp_path, chunk_size=1000,
                       _opener=lambda url: FakeResponse(payload))
    assert mdl.get_download_error("base") is None
    assert mdl.model_path("base", tmp_path).exists()


def test_duplicate_download_guard(tmp_path):
    started = threading.Event()
    release = threading.Event()

    class SlowResponse(FakeResponse):
        def read(self, n):
            started.set()
            release.wait(timeout=10)
            return super().read(n)

    t = threading.Thread(
        target=lambda: mdl.download_model(
            "small", tmp_path, _opener=lambda url: SlowResponse(b"z" * 10)),
        daemon=True)
    t.start()
    started.wait(timeout=10)
    with pytest.raises(RuntimeError, match="already downloading"):
        mdl.download_model("small", tmp_path,
                           _opener=lambda url: FakeResponse(b"z"))
    release.set()
    t.join(timeout=10)


def test_list_models_status(tmp_path):
    mdl.model_path("tiny", tmp_path).write_bytes(b"stub")
    listed = {m.id: m for m in mdl.list_models(tmp_path)}
    assert listed["tiny"].status == "downloaded"
    assert listed["tiny"].local_path is not None
    assert listed["base"].status == "not_downloaded"


def test_delete_model(tmp_path):
    p = mdl.model_path("tiny", tmp_path)
    p.write_bytes(b"stub")
    assert mdl.delete_model("tiny", tmp_path) is True
    assert not p.exists()
    assert mdl.delete_model("tiny", tmp_path) is False
