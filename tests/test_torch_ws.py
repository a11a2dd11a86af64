"""WebSocket session channel: RFC 6455 framing unit tests + a live
full-duplex dictation cycle (audio up / verbs up / events down in ONE
socket — the Tauri-IPC single-channel analog, src-tauri/src/lib.rs:117-134
+ state.rs:453)."""

import io
import json
import struct
import threading

import numpy as np
import pytest

import torch

from nobs_whisper_torch.serve import ws as wsmod

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores


# ---- framing unit tests ----------------------------------------------------

def _unmasked_frame(opcode, payload, fin=True):
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head.append(n)
    elif n < (1 << 16):
        head.append(126)
        head += struct.pack(">H", n)
    else:
        head.append(127)
        head += struct.pack(">Q", n)
    return bytes(head) + payload


def _masked_frame(opcode, payload, mask=b"\x12\x34\x56\x78", fin=True):
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head.append(0x80 | n)
    elif n < (1 << 16):
        head.append(0x80 | 126)
        head += struct.pack(">H", n)
    else:
        head.append(0x80 | 127)
        head += struct.pack(">Q", n)
    return bytes(head) + mask + wsmod._unmask(payload, mask)


def test_accept_key_rfc_example():
    # the worked example from RFC 6455 §1.3
    assert wsmod.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 125, 126, 65535, 65536,
                               100_003])
def test_unmask_roundtrip(n):
    rng = np.random.RandomState(n % 97)
    payload = rng.bytes(n)
    mask = rng.bytes(4)
    masked = wsmod._unmask(payload, mask)
    # XOR with the repeating mask, verified against the naive loop
    naive = bytes(b ^ mask[i % 4] for i, b in enumerate(masked[:256]))
    assert naive == payload[:256]
    assert wsmod._unmask(masked, mask) == payload


@pytest.mark.parametrize("n", [0, 5, 125, 126, 300, 65535, 65536, 70000])
def test_frame_length_encodings(n):
    payload = bytes(n % 251 for n in range(n))
    sock = wsmod.WebSocket(io.BytesIO(_masked_frame(wsmod.OP_BINARY,
                                                    payload)),
                           io.BytesIO())
    opcode, got = sock.recv()
    assert opcode == wsmod.OP_BINARY and got == payload


def test_send_recv_roundtrip_unmasked():
    out = io.BytesIO()
    wsmod.WebSocket(io.BytesIO(), out).send_json({"verb": "start"})
    sock = wsmod.WebSocket(io.BytesIO(out.getvalue()), io.BytesIO())
    opcode, payload = sock.recv()
    assert opcode == wsmod.OP_TEXT
    assert json.loads(payload) == {"verb": "start"}


def test_recv_reassembles_continuation_and_answers_ping():
    stream = (_masked_frame(wsmod.OP_TEXT, b"hel", fin=False)
              + _masked_frame(wsmod.OP_PING, b"hb")
              + _masked_frame(wsmod.OP_CONT, b"lo", fin=True)
              + _masked_frame(wsmod.OP_CLOSE, struct.pack(">H", 1000)))
    out = io.BytesIO()
    sock = wsmod.WebSocket(io.BytesIO(stream), out)
    assert sock.recv() == (wsmod.OP_TEXT, b"hello")
    assert sock.recv() is None            # close frame
    written = out.getvalue()
    assert _unmasked_frame(wsmod.OP_PONG, b"hb") in written
    assert written.endswith(
        _unmasked_frame(wsmod.OP_CLOSE, struct.pack(">H", 1000)))


def test_oversized_frame_rejected():
    head = bytes([0x80 | wsmod.OP_BINARY, 127]) \
        + struct.pack(">Q", wsmod.MAX_FRAME + 1)
    sock = wsmod.WebSocket(io.BytesIO(head), io.BytesIO())
    with pytest.raises(wsmod.WebSocketError):
        sock.recv()


def test_truncated_frame_raises():
    frame = _masked_frame(wsmod.OP_BINARY, b"x" * 64)[:20]
    sock = wsmod.WebSocket(io.BytesIO(frame), io.BytesIO())
    with pytest.raises(wsmod.WebSocketError):
        sock.recv()


def test_is_upgrade_request():
    class H(dict):
        pass

    good = H(Connection="keep-alive, Upgrade", Upgrade="WebSocket")
    good["Sec-WebSocket-Key"] = "abc"
    assert wsmod.is_upgrade_request(good)
    assert not wsmod.is_upgrade_request(H(Connection="close"))


# ---- live server integration ----------------------------------------------

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    import os
    os.environ["NOBS_WHISPER_TPU_HOME"] = \
        str(tmp_path_factory.mktemp("home"))
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    engine = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(engine, port=port, background=True)
    yield f"http://127.0.0.1:{port}", httpd
    httpd.shutdown()


def _recv_json_until(sock, key, timeout_replies=50):
    """Drain frames until one carrying `key` arrives (events and verb
    replies interleave on the shared socket)."""
    for _ in range(timeout_replies):
        msg = sock.recv()
        assert msg is not None, "socket closed early"
        opcode, payload = msg
        assert opcode == wsmod.OP_TEXT
        obj = json.loads(payload)
        if key in obj:
            return obj
    raise AssertionError(f"no frame with {key!r} in {timeout_replies}")


def test_ws_full_duplex_dictation(server):
    from nobs_whisper_torch.client import Client
    base, _ = server
    c = Client(base)
    with c.session(language="en") as s:
        sock = s.websocket()
        try:
            sock.send_json({"verb": "start"})
            reply = _recv_json_until(sock, "reply")
            assert reply["reply"] == "start" and reply["started"]

            rng = np.random.RandomState(0)
            audio = (rng.randn(8000) * 0.2).astype("<f4")
            sock.send_binary(audio.tobytes())      # binary = PCM push

            sock.send_json({"verb": "stop"})
            # events stream down interleaved; the stop reply carries the
            # final transcript
            reply = _recv_json_until(sock, "reply")
            assert reply["reply"] == "stop"
            assert isinstance(reply["transcript"], str)
        finally:
            sock.close()


def test_ws_events_stream_down(server):
    from nobs_whisper_torch.client import Client
    base, _ = server
    c = Client(base)
    with c.session(language="en") as s:
        sock = s.websocket()
        try:
            sock.send_json({"verb": "start"})
            _recv_json_until(sock, "reply")
            rng = np.random.RandomState(1)
            sock.send_binary(
                (rng.randn(8000) * 0.2).astype("<f4").tobytes())
            sock.send_json({"verb": "stop"})
            states, got_final = [], False
            for _ in range(50):
                msg = sock.recv()
                if msg is None:
                    break
                obj = json.loads(msg[1])
                if "event" in obj:
                    states.append(obj["event"]["state"])
                    if obj["event"]["is_final"]:
                        got_final = True
                        break
            assert got_final, states
            assert "recording" in states and "done" in states
        finally:
            sock.close()


def test_ws_toggle_cancel_and_bad_frames(server):
    from nobs_whisper_torch.client import Client
    base, _ = server
    c = Client(base)
    with c.session(language="en") as s:
        sock = s.websocket()
        try:
            sock.send_json({"verb": "toggle"})
            r = _recv_json_until(sock, "reply")
            assert r["recording"] is True
            sock.send_json({"verb": "nope"})
            assert "error" in _recv_json_until(sock, "error")
            sock.send_text("not json")
            assert "error" in _recv_json_until(sock, "error")
            sock.send_json({"verb": "cancel"})
            r = _recv_json_until(sock, "reply")
            assert r["reply"] == "cancel"
        finally:
            sock.close()


def test_ws_rejects_unknown_session_and_plain_get(server):
    import urllib.error
    import urllib.request
    base, _ = server
    with pytest.raises(wsmod.WebSocketError):
        wsmod.client_connect(base.replace("http://", "ws://", 1)
                             + "/sessions/nonexistent/ws", timeout=10)
    # a plain GET (no upgrade headers) must get a 400, not a hang
    with pytest.raises(urllib.error.HTTPError) as ei:
        from nobs_whisper_torch.client import Client
        c = Client(base)
        with c.session(language="en") as s:
            urllib.request.urlopen(f"{base}/sessions/{s.id}/ws",
                                   timeout=10)
    assert ei.value.code == 400


def test_ws_channel_survives_multiple_cycles(server):
    """The socket is a PERSISTENT channel: events must stream for a
    second recording cycle too (the pump may not exit at the first
    final event), and a malformed binary frame gets a JSON error
    instead of killing the connection."""
    from nobs_whisper_torch.client import Client
    base, _ = server
    c = Client(base)
    rng = np.random.RandomState(7)

    def read_until(sock, key, events, tries=80):
        """Like _recv_json_until but COLLECTS event frames instead of
        discarding them — event/reply ordering on the shared socket is
        nondeterministic (pump thread vs handler thread)."""
        for _ in range(tries):
            opcode, payload = sock.recv()
            obj = json.loads(payload)
            if "event" in obj:
                events.append(obj["event"])
            if key in obj:
                return obj
        raise AssertionError(f"no frame with {key!r}")

    with c.session(language="en") as s:
        sock = s.websocket()
        try:
            for cycle in range(2):
                events = []
                sock.send_json({"verb": "start"})
                reply = read_until(sock, "reply", events)
                assert reply["started"], cycle
                if cycle == 0:
                    sock.send_binary(b"\x00" * 6)   # truncated f32 PCM
                    err = read_until(sock, "error", events)
                    assert err["error"] == "bad frame"
                sock.send_binary(
                    (rng.randn(8000) * 0.2).astype("<f4").tobytes())
                sock.send_json({"verb": "stop"})
                reply = read_until(sock, "reply", events)
                assert reply["reply"] == "stop", cycle
                # the cycle's final event must arrive on the socket too
                # (may already have been collected alongside the reply)
                while not any(e.get("is_final") for e in events):
                    read_until(sock, "event", events)
                assert any(e.get("is_final") for e in events), cycle
        finally:
            sock.close()
