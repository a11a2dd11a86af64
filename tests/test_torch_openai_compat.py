"""OpenAI-compatible API surface: /v1/audio/transcriptions,
/v1/audio/translations, /v1/models — wire format, multipart parsing,
response_format variants, error envelopes. Runs against a live server
with the tiny-random engine (same fixture shape as test_server.py)."""

import io
import json
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch


torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores


@pytest.fixture(scope="module")
def server(tmp_path_factory):
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
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def _wav_bytes(n_samples=8000, seed=0):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(n_samples) * 0.2).astype(np.float32)
    pcm16 = np.clip(audio * 32767, -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


BOUNDARY = "xNwtTestBoundary731"


def _multipart(parts):
    """parts: list of (name, filename_or_None, bytes_or_str)."""
    out = io.BytesIO()
    for name, filename, value in parts:
        out.write(f"--{BOUNDARY}\r\n".encode())
        disp = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        out.write((disp + "\r\n").encode())
        if filename:
            out.write(b"Content-Type: application/octet-stream\r\n")
        out.write(b"\r\n")
        out.write(value if isinstance(value, bytes) else value.encode())
        out.write(b"\r\n")
    out.write(f"--{BOUNDARY}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={BOUNDARY}"


def _post(base, path, parts, expect_json=True):
    body, ctype = _multipart(parts)
    req = urllib.request.Request(base + path, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        raw = r.read()
        return (json.loads(raw) if expect_json
                else (raw, r.headers.get("Content-Type", "")))


def _post_err(base, path, parts):
    body, ctype = _multipart(parts)
    req = urllib.request.Request(base + path, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def test_models_listing(server):
    with urllib.request.urlopen(server + "/v1/models", timeout=30) as r:
        out = json.loads(r.read())
    assert out["object"] == "list"
    ids = [m["id"] for m in out["data"]]
    assert ids[0] == "whisper-1"
    assert "large-v3-turbo" in ids and len(ids) == 13
    assert all(m["object"] == "model" for m in out["data"])


def test_transcription_json(server):
    out = _post(server, "/v1/audio/transcriptions",
                [("file", "a.wav", _wav_bytes()),
                 ("model", None, "whisper-1"),
                 ("language", None, "en")])
    assert set(out) == {"text"} and isinstance(out["text"], str)


def test_transcription_text_format(server):
    raw, ctype = _post(server, "/v1/audio/transcriptions",
                       [("file", "a.wav", _wav_bytes()),
                        ("language", None, "en"),
                        ("response_format", None, "text")],
                       expect_json=False)
    assert ctype.startswith("text/plain")
    assert raw.decode().endswith("\n")


def test_transcription_srt_format(server):
    raw, ctype = _post(server, "/v1/audio/transcriptions",
                       [("file", "a.wav", _wav_bytes()),
                        ("language", None, "en"),
                        ("response_format", None, "srt")],
                       expect_json=False)
    assert ctype.startswith("application/x-subrip")
    text = raw.decode()
    if text.strip():  # random weights may emit an empty transcript
        assert "-->" in text


def test_transcription_verbose_json(server):
    out = _post(server, "/v1/audio/transcriptions",
                [("file", "a.wav", _wav_bytes()),
                 ("language", None, "en"),
                 ("response_format", None, "verbose_json")])
    assert out["task"] == "transcribe"
    assert out["language"] == "en"
    assert abs(out["duration"] - 0.5) < 1e-6
    for seg in out["segments"]:
        assert {"id", "seek", "start", "end", "text", "tokens",
                "temperature", "avg_logprob", "compression_ratio",
                "no_speech_prob"} <= set(seg)


def test_transcription_word_granularity(server):
    """The "word" granularity reaches the engine's word timestamps: the
    verbose_json answer carries a non-empty ``words`` list, each word
    inside the clip and in order, beside the same segments as "segment"
    alone, which carries no ``words``."""
    words = _post(server, "/v1/audio/transcriptions",
                  [("file", "a.wav", _wav_bytes()),
                   ("language", None, "en"),
                   ("response_format", None, "verbose_json"),
                   ("timestamp_granularities[]", None, "word"),
                   ("timestamp_granularities[]", None, "segment")])
    assert words["words"]
    starts = [w["start"] for w in words["words"]]
    assert starts == sorted(starts)
    assert all(0.0 <= w["start"] <= w["end"] <= words["duration"] + 1e-3
               for w in words["words"])
    out = _post(server, "/v1/audio/transcriptions",
                [("file", "a.wav", _wav_bytes()),
                 ("language", None, "en"),
                 ("response_format", None, "verbose_json"),
                 ("timestamp_granularities[]", None, "segment")])
    assert "segments" in out and "words" not in out
    assert out["text"] == words["text"]


def test_translation_endpoint(server):
    out = _post(server, "/v1/audio/translations",
                [("file", "a.wav", _wav_bytes()),
                 ("response_format", None, "verbose_json")])
    assert out["task"] == "translate"


def test_raw_pcm_payload(server):
    rng = np.random.RandomState(1)
    pcm = (rng.randn(4000) * 0.2).astype("<f4").tobytes()
    out = _post(server, "/v1/audio/transcriptions",
                [("file", "a.pcm", pcm), ("language", None, "en")])
    assert "text" in out


def test_error_missing_file(server):
    code, out = _post_err(server, "/v1/audio/transcriptions",
                          [("model", None, "whisper-1")])
    assert code == 400
    assert out["error"]["type"] == "invalid_request_error"
    assert out["error"]["param"] == "file"


def test_error_bad_response_format(server):
    code, out = _post_err(server, "/v1/audio/transcriptions",
                          [("file", "a.wav", _wav_bytes()),
                           ("response_format", None, "yaml")])
    assert code == 400
    assert out["error"]["param"] == "response_format"


def test_error_granularity_without_verbose(server):
    code, out = _post_err(server, "/v1/audio/transcriptions",
                          [("file", "a.wav", _wav_bytes()),
                           ("timestamp_granularities[]", None, "word")])
    assert code == 400
    assert out["error"]["param"] == "timestamp_granularities"


def test_error_unsupported_container(server):
    code, out = _post_err(server, "/v1/audio/transcriptions",
                          [("file", "a.mp3", b"\xff\xfbnot-really-mp3")])
    assert code == 400
    assert "unsupported audio format" in out["error"]["message"]


def test_error_not_multipart(server):
    req = urllib.request.Request(
        server + "/v1/audio/transcriptions", data=b"{}", method="POST",
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as e:
        assert e.code == 400
        assert "multipart" in json.loads(e.read())["error"]["message"]
    else:
        raise AssertionError("expected 400")


def test_multipart_parser_unit():
    from nobs_whisper_torch.serve.openai_compat import parse_multipart
    body, ctype = _multipart([("a", None, "x"),
                              ("a", None, "y"),
                              ("f", "n.bin", b"\x00\x01binary\xff")])
    fields = parse_multipart(body, ctype)
    assert [v for _, v in fields["a"]] == [b"x", b"y"]
    assert fields["f"][0] == ("n.bin", b"\x00\x01binary\xff")
