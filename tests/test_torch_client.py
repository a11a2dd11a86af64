"""Python client SDK (nobs_whisper_torch/client.py) against a live
server: status verbs, config round-trip, model registry, one-shot
transcription (array / WAV path / subtitle formats), streaming session
lifecycle with SSE events, and error envelopes -> ClientError."""

import threading

import numpy as np
import pytest

import torch

from nobs_whisper_torch.client import Client, ClientError, Session

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    import os
    os.environ["NOBS_WHISPER_TPU_HOME"] = str(tmp_path_factory.mktemp("home"))

    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    engine = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(engine, port=port, background=True)
    yield Client(f"http://127.0.0.1:{port}")
    httpd.shutdown()


def _audio(n=8000, seed=0):
    return (np.random.RandomState(seed).randn(n) * 0.2).astype(np.float32)


def test_health_and_state(client):
    h = client.health()
    assert h["ok"] and h["loaded"]
    assert isinstance(client.state(), dict)
    assert "stages" in client.stats()


def test_config_round_trip(client):
    cfg = client.get_config()
    assert "language" in cfg
    out = client.set_config(language="en", custom_vocabulary="JAX, TPU")
    assert out["language"] == "en"
    assert client.get_config()["custom_vocabulary"] == "JAX, TPU"
    client.set_config(language="auto", custom_vocabulary="")


def test_models_registry(client):
    ms = client.models()
    ids = {m["id"] for m in ms}
    assert "large-v3-turbo" in ids and len(ms) >= 12
    assert client.download_progress("tiny") is None
    assert client.delete_model("tiny") is False
    with pytest.raises(ClientError) as e:
        client.download_model("no-such-model")
    assert e.value.status == 404


def test_transcribe_array(client):
    out = client.transcribe(_audio(), language="en")
    assert {"text", "language", "segments"} <= set(out)
    assert out["language"] == "en"


def test_transcribe_wav_path(client, tmp_path):
    import wave
    p = tmp_path / "a.wav"
    pcm16 = np.clip(_audio() * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(p), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm16.tobytes())
    out = client.transcribe(str(p), language="en")
    assert out["segments"] and out["text"]
    # word timestamps reach the engine: every segment carries its words,
    # which partition its text tokens' words in order
    out = client.transcribe(str(p), language="en", word_timestamps=True)
    assert out["segments"] and all(
        s["words"] is not None for s in out["segments"])
    assert any(s["words"] for s in out["segments"])
    for s in out["segments"]:
        assert all(s["start"] - 1e-6 <= w["start"] <= w["end"]
                   for w in s["words"])


def test_transcribe_srt_format(client):
    out = client.transcribe(_audio(), language="en", format="srt")
    assert isinstance(out, str)


def test_transcribe_bad_format_raises(client):
    with pytest.raises(ClientError) as e:
        client.transcribe(_audio(), language="en", format="yaml")
    assert e.value.status == 400
    assert "format" in e.value.message


def test_transcribe_rejects_non_wav_path(client, tmp_path):
    p = tmp_path / "a.mp3"
    p.write_bytes(b"\xff\xfbnot-a-wav")
    with pytest.raises(ValueError):
        client.transcribe(str(p))


def test_session_lifecycle_with_events(client):
    with client.session(language="en", sample_rate=16000) as s:
        assert isinstance(s, Session)
        events = []
        done = threading.Event()
        stream = s.events()   # subscription live before start()

        def collect():
            for ev in stream:
                events.append(ev)
            done.set()

        t = threading.Thread(target=collect, daemon=True)
        t.start()
        assert s.start() is True
        assert s.state() == "recording"
        s.push_audio(_audio(16000))
        text = s.stop()
        assert isinstance(text, str)
        assert done.wait(timeout=120)
        states = [e.state for e in events]
        assert "recording" in states
        assert events[-1].is_final
    # context-manager exit deleted it server-side
    assert s.id not in client.state()


def test_session_press_release_toggle_mode(client):
    client.set_config(push_to_talk=False)
    s = client.session(language="en", sample_rate=16000)
    try:
        assert s.press()["recording"] is True     # toggle mode: press=toggle
        s.push_audio(_audio(4000, seed=1))
        s.release()                               # toggle mode: no-op
        assert s.state() == "recording"
        out = s.press()                           # second press stops
        assert out["recording"] is False
    finally:
        s.delete()


def test_session_press_release_ptt_mode(client):
    client.set_config(push_to_talk=True)
    try:
        s = client.session(language="en", sample_rate=16000)
        assert s.press()["started"] is True       # ptt: press=start
        s.push_audio(_audio(4000, seed=2))
        s.release()                               # ptt: release=stop
        assert s.state() in ("processing", "done")
        s.delete()
    finally:
        client.set_config(push_to_talk=False)


def test_unknown_session_raises(client):
    with pytest.raises(ClientError) as e:
        Session(client, "deadbeef0000").start()
    assert e.value.status == 404
