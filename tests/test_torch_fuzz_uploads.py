"""Adversarial-input fuzz for every byte-input surface: the GGML
checkpoint reader, the WAV reader, the FLAC decoder, and the HTTP
one-shot upload endpoint.

The contract under fuzz: structured corruption (truncation at every
boundary) and random bit-flips of valid files must yield EITHER a
successful parse (flip landed in payload) OR a clean ValueError — never
a struct.error / IndexError / hang / unbounded allocation — and over
HTTP always a 4xx/5xx JSON body with the server still alive after.
Reference bar: the closest hygiene the reference has is partial-download
cleanup (src-tauri/src/model.rs:287); its parsers come from OS
libraries, ours are hand-written, so they get fuzz pinned here.
"""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nobs_whisper_torch.audio.flac import read_flac, write_flac
from nobs_whisper_torch.audio.io import read_wav, write_wav
from nobs_whisper_torch.core.ggml import read_ggml
from nobs_whisper_torch.utils.testing import sine_audio, write_tiny_checkpoint

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores

ACCEPTABLE = (ValueError,)       # the ONLY exception a bad input may raise


def _fuzz_one(parse, blob: bytes, label: str):
    try:
        parse(blob)
    except ACCEPTABLE:
        pass
    except Exception as e:                                # pragma: no cover
        pytest.fail(f"{label}: {type(e).__name__}: {e}")


def _truncations(blob: bytes):
    """Cut points at structural boundaries plus a sweep."""
    n = len(blob)
    cuts = {0, 1, 2, 3, 4, 7, 8, 11, 12, 41, 42, 43, n - 1, n - 2,
            n - 7, n // 2, n // 3, 2 * n // 3}
    return sorted(c for c in cuts if 0 <= c < n)


def _bit_flips(blob: bytes, n_flips: int, seed: int):
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(blob, np.uint8).copy()
    for _ in range(n_flips):
        out = arr.copy()
        i = rng.integers(0, len(out))
        out[i] ^= 1 << rng.integers(0, 8)
        yield int(i), out.tobytes()


# --------------------------------------------------------------------------
# GGML checkpoint reader

@pytest.fixture(scope="module")
def ggml_blob(tmp_path_factory):
    p = tmp_path_factory.mktemp("g") / "m.bin"
    write_tiny_checkpoint(str(p))
    return p.read_bytes()


def _parse_ggml(blob, tmp_path):
    p = tmp_path / "fuzz.bin"
    p.write_bytes(blob)
    return read_ggml(str(p))


def test_ggml_truncations_clean(ggml_blob, tmp_path):
    for cut in _truncations(ggml_blob):
        _fuzz_one(lambda b: _parse_ggml(b, tmp_path), ggml_blob[:cut],
                  f"ggml truncated at {cut}")


def test_ggml_bit_flips_clean(ggml_blob, tmp_path):
    for i, mutated in _bit_flips(ggml_blob, 120, seed=5):
        _fuzz_one(lambda b: _parse_ggml(b, tmp_path), mutated,
                  f"ggml bit flip at byte {i}")


def test_ggml_hostile_headers(tmp_path):
    """Hand-built hostile headers: huge vocab count, negative token
    length, absurd tensor rank/shape — all clean ValueErrors, none may
    hang (negative lengths used to walk the cursor backwards) or
    allocate unboundedly."""
    import struct
    magic = struct.pack("<I", 0x67676d6c)
    hp_ok = struct.pack("<11i", 1000, 64, 64, 4, 2, 96, 64, 4, 2, 80, 0)

    def build(*parts):
        return magic + b"".join(parts)

    cases = {
        "hparams negative": struct.pack("<11i", -5, 64, 64, 4, 2, 96, 64,
                                        4, 2, 80, 0),
        "hparams absurd": struct.pack("<11i", 1 << 30, 64, 64, 4, 2, 96,
                                      64, 4, 2, 80, 0),
        "mel dims negative": hp_ok + struct.pack("<2i", -1, 100),
        "mel dims huge": hp_ok + struct.pack("<2i", 1 << 30, 1 << 30),
        "vocab count huge": hp_ok + struct.pack("<2i", 0, 0)
        + struct.pack("<i", 1 << 30),
        "token length negative": hp_ok + struct.pack("<2i", 0, 0)
        + struct.pack("<i", 3) + struct.pack("<i", -4),
        "tensor rank absurd": hp_ok + struct.pack("<2i", 0, 0)
        + struct.pack("<i", 0) + struct.pack("<3i", 99, 4, 0),
        "tensor dim negative": hp_ok + struct.pack("<2i", 0, 0)
        + struct.pack("<i", 0) + struct.pack("<3i", 2, 0, 0)
        + struct.pack("<2i", -8, 8),
        "tensor type unknown": hp_ok + struct.pack("<2i", 0, 0)
        + struct.pack("<i", 0) + struct.pack("<3i", 1, 0, 77)
        + struct.pack("<i", 32),
    }
    for label, payload in cases.items():
        blob = build(payload)
        with pytest.raises(ValueError):
            _parse_ggml(blob, tmp_path)


def test_ggml_valid_still_reads(ggml_blob, tmp_path):
    ckpt = _parse_ggml(ggml_blob, tmp_path)
    assert ckpt.tensors


# --------------------------------------------------------------------------
# WAV reader

@pytest.fixture(scope="module")
def wav_blob():
    buf = io.BytesIO()
    write_wav(buf, sine_audio(0.5))
    return buf.getvalue()


def test_wav_truncations_clean(wav_blob):
    for cut in _truncations(wav_blob):
        _fuzz_one(read_wav, wav_blob[:cut], f"wav truncated at {cut}")


def test_wav_bit_flips_clean(wav_blob):
    for i, mutated in _bit_flips(wav_blob, 120, seed=6):
        _fuzz_one(read_wav, mutated, f"wav bit flip at byte {i}")


def test_float_wav_hostile_fmt():
    """IEEE-float RIFF path: short fmt chunk, zero channels, truncated
    data — clean errors."""
    import struct

    def riff(chunks):
        body = b"WAVE" + b"".join(
            cid + struct.pack("<I", len(c)) + c for cid, c in chunks)
        return b"RIFF" + struct.pack("<I", len(body)) + body

    short_fmt = riff([(b"fmt ", b"\x03\x00"), (b"data", b"\x00" * 8)])
    with pytest.raises(ValueError):
        read_wav(short_fmt)

    fmt3 = struct.pack("<HHIIHH", 3, 1, 16000, 64000, 4, 32)
    odd_data = riff([(b"fmt ", fmt3), (b"data", b"\x00" * 6)])  # 6 % 4 != 0
    with pytest.raises(ValueError):
        read_wav(odd_data)

    no_data = riff([(b"fmt ", fmt3)])
    with pytest.raises(ValueError):
        read_wav(no_data)


# --------------------------------------------------------------------------
# FLAC decoder (CRC-verified path: flips are mostly caught by CRC)

@pytest.fixture(scope="module")
def flac_blob():
    buf = io.BytesIO()
    write_flac(buf, sine_audio(0.5))
    return buf.getvalue()


def test_flac_truncations_clean(flac_blob):
    for cut in _truncations(flac_blob):
        _fuzz_one(lambda b: read_flac(b, verify=True), flac_blob[:cut],
                  f"flac truncated at {cut}")


def test_flac_bit_flips_clean(flac_blob):
    for i, mutated in _bit_flips(flac_blob, 120, seed=7):
        _fuzz_one(lambda b: read_flac(b, verify=True), mutated,
                  f"flac bit flip at byte {i}")


def test_flac_bit_flips_unverified_still_clean(flac_blob):
    """Without CRC verification the decoder walks further into corrupt
    frames — it must still fail (or succeed) cleanly."""
    for i, mutated in _bit_flips(flac_blob, 120, seed=8):
        _fuzz_one(lambda b: read_flac(b, verify=False), mutated,
                  f"flac(unverified) bit flip at byte {i}")


# --------------------------------------------------------------------------
# HTTP upload surface: POST /transcribe with hostile bodies

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    import os
    import socket

    import torch

    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.server import serve

    os.environ["NOBS_WHISPER_TPU_HOME"] = str(tmp_path_factory.mktemp("home"))
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    engine = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(engine, port=port, background=True)
    yield f"http://127.0.0.1:{port}", httpd
    httpd.shutdown()


def _post_raw(base, path, data):
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_upload_fuzz(server, wav_blob, flac_blob):
    base, _ = server
    hostile = [
        b"",                                     # empty body
        b"\x00" * 3,                             # odd-length raw PCM
        b"RIFF",                                 # bare magic
        b"fLaC",                                 # bare magic
        b"RIFF" + b"\xff" * 64,                  # garbage RIFF
        b"fLaC" + b"\xff" * 64,                  # garbage FLAC metadata
        wav_blob[:30],                           # truncated WAV
        flac_blob[:30],                          # truncated FLAC
    ]
    hostile += [m for _, m in _bit_flips(wav_blob, 10, seed=9)]
    hostile += [m for _, m in _bit_flips(flac_blob, 10, seed=10)]
    for idx, body in enumerate(hostile):
        code, resp = _post_raw(base, "/transcribe", body)
        # parse either succeeds (flip in payload) or is a JSON error --
        # never a dropped connection or an HTML traceback
        assert code in (200, 400, 404, 500), (idx, code)
        parsed = json.loads(resp)
        if code != 200:
            assert "error" in parsed, (idx, parsed)
    # the server survived the corpus: a good request still works
    good = sine_audio(0.3).astype("<f4").tobytes()
    code, resp = _post_raw(base, "/transcribe", good)
    assert code == 200 and "text" in json.loads(resp)
