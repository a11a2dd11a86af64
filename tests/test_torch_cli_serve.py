"""The port's CLI verbs ``serve``, ``models`` and ``config``, each in a
subprocess with its own home directory (``NOBS_WHISPER_TPU_HOME``), on the
CPU: the server answers ``/health`` and ``/transcribe`` and exits 0 on
SIGINT; a registry id resolves through the config; and ``serve`` without
``--device cpu`` on a machine with no card raises instead of serving on
the CPU. Nothing here reaches the network: ``models download`` is run
only for an id the registry does not know."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(home):
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "PYTHONPATH": REPO, "HOME": str(home),
            "NOBS_WHISPER_TPU_HOME": str(home), "OMP_NUM_THREADS": "1"}


def _cli(home, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "nobs_whisper_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO, env=_env(home),
        timeout=timeout)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = tmp_path_factory.mktemp("m") / "ggml-tiny.bin"
    write_tiny_checkpoint(str(path))
    return path


def _wait_health(base, proc, deadline_s):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if proc.poll() is not None:
            raise AssertionError(f"serve exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-3000:]}")
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.2)
    raise AssertionError("serve did not answer /health in time")


def test_serve_cpu_answers_and_exits_on_sigint(tmp_path, ckpt):
    """``serve --device cpu`` (int8 serving path, batched, warmed up)
    answers /health with the model loaded and a one-shot /transcribe
    through the batcher (the server's default options are the batcher's),
    and exits 0 on SIGINT after closing its engine."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "nobs_whisper_torch.cli", "serve",
         "--device", "cpu", "--model", str(ckpt), "--dtype", "float32",
         "--batch", "2", "--warmup", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_env(tmp_path))
    try:
        health = _wait_health(base, proc, 90)
        assert health["loaded"] and health["model"] == str(ckpt)
        audio = (np.random.RandomState(3).randn(16000) * 0.2)
        req = urllib.request.Request(
            base + "/transcribe?language=en",
            data=audio.astype("<f4").tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert isinstance(out["text"], str) and out["language"] == "en"
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["decode"]["chunks"] == 1
        assert stats["batcher"]["max_batch"] == 2   # the warmup's sizes
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        assert "warmup done: sizes [1, 2]" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_without_a_card_raises(tmp_path, ckpt):
    """The default device is the card: with no card, ``serve`` raises
    before it listens, and never serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port = _free_port()
    r = _cli(tmp_path, "serve", "--model", str(ckpt), "--port", str(port))
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    with socket.socket() as s:
        assert s.connect_ex(("127.0.0.1", port)) != 0   # nothing listens


def test_models_verb(tmp_path, ckpt):
    r = _cli(tmp_path, "models", "list")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 12 and all(ln.startswith("[ ]") for ln in lines)
    # a registry file on disk shows as downloaded, and deletes
    dest = tmp_path / "models" / "ggml-tiny.bin"
    dest.write_bytes(ckpt.read_bytes())
    r = _cli(tmp_path, "models", "list")
    assert any(ln.startswith("[*] tiny ") for ln in r.stdout.splitlines())
    assert _cli(tmp_path, "models", "delete", "tiny").stdout.strip() \
        == "deleted"
    assert _cli(tmp_path, "models", "delete", "tiny").stdout.strip() \
        == "not present"
    # an id the registry does not know fails before any network access
    r = _cli(tmp_path, "models", "download", "no-such-model")
    assert r.returncode != 0 and "unknown model" in r.stderr


def test_config_verb(tmp_path):
    r = _cli(tmp_path, "config", "get")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["language"] == "auto"
    r = _cli(tmp_path, "config", "set", "language=ko", "push_to_talk=true",
             "max_recording_duration=30")
    assert r.returncode == 0, r.stderr
    got = json.loads(_cli(tmp_path, "config", "get").stdout)
    assert (got["language"], got["push_to_talk"],
            got["max_recording_duration"]) == ("ko", True, 30)
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["language"] == "ko"     # persisted
    r = _cli(tmp_path, "config", "set", "no_such_key=1")
    assert r.returncode != 0


def test_registry_id_resolves_through_config(tmp_path, ckpt):
    """``--model`` takes a registry id, and without ``--model`` the
    configured ``selected_model``: both load the registry's file under
    the home directory, and transcribe as the explicit path does."""
    from nobs_whisper_torch.audio.io import write_wav
    from nobs_whisper_torch.utils.testing import speech_like_audio
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "ggml-tiny.bin").write_bytes(ckpt.read_bytes())
    wav = tmp_path / "a.wav"
    write_wav(str(wav), speech_like_audio(1.0, seed=2), 16000)
    common = ["--device", "cpu", "--dtype", "float32", "--language", "en",
              "--temperature-increment", "0", "--json"]
    r = _cli(tmp_path, "transcribe", str(wav), *common)
    assert r.returncode == 2 and "no model selected" in r.stderr
    outs = [_cli(tmp_path, "transcribe", str(wav), "--model", str(ckpt),
                 *common)]
    outs.append(_cli(tmp_path, "transcribe", str(wav), "--model", "tiny",
                     *common))
    assert _cli(tmp_path, "config", "set",
                "selected_model=tiny").returncode == 0
    outs.append(_cli(tmp_path, "transcribe", str(wav), *common))
    for r in outs:
        assert r.returncode == 0, r.stderr[-2000:]
    texts = [json.loads(r.stdout.strip().splitlines()[-1]) for r in outs]
    assert texts[0] == texts[1] == texts[2]
