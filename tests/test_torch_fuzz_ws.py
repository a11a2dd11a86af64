"""Adversarial fuzz of the LIVE WebSocket surface (VERDICT r4 item 4).

The upload fuzz (test_fuzz_uploads.py) hardened the byte parsers; this
drives hostile bytes at a live server's WS endpoint with raw sockets:
hostile handshakes, truncated masked frames mid-message, length-field
lies vs MAX_FRAME, fragmentation/opcode abuse, junk JSON verbs, and
abrupt disconnects mid-session.

The contract under fuzz: every hostile case ends with the CONNECTION
closed or cleanly answered — never a hang, never an HTTP response
written into RFC 6455 land, never a leaked event queue — and the
server keeps serving: /health answers and a well-behaved WS cycle on
the SAME session still works after every attack. Reference bar: the
reference's transport is in-process Tauri IPC (no hostile peers
possible); a network transport must earn that robustness
(serve/ws.py:37 MAX_FRAME was the start — this pins the rest).
"""

import json
import os
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch


torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint

    os.environ["NOBS_WHISPER_TPU_HOME"] = str(
        tmp_path_factory.mktemp("home"))
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    engine = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    port = _free_port()
    httpd = serve(engine, port=port, background=True)
    yield f"http://127.0.0.1:{port}", httpd
    httpd.shutdown()


def _post(base, path, data=b""):
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture
def session(server):
    base, httpd = server
    sid = _post(base, "/sessions", json.dumps(
        {"language": "en", "sample_rate": 16000}).encode())["session"]
    yield base, httpd, sid
    req = urllib.request.Request(base + f"/sessions/{sid}",
                                 method="DELETE")
    urllib.request.urlopen(req, timeout=30).read()


def _raw_connect(base):
    host, port = base.split("//")[1].split(":")
    s = socket.create_connection((host, int(port)), timeout=20)
    s.settimeout(20)
    return s


def _handshake(sock, sid, host="127.0.0.1", key="x3JJHMbDL1EzLkh9GBhXDw=="):
    sock.sendall((
        f"GET /sessions/{sid}/ws HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    head = b""
    while b"\r\n\r\n" not in head:
        chunk = sock.recv(65536)
        if not chunk:
            break
        head += chunk
    return head


def _masked_frame(opcode, payload, fin=True, mask=b"\x01\x02\x03\x04"):
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
    head += mask
    body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return bytes(head) + body


def _drain_until_closed(sock, max_bytes=1 << 20, timeout=15):
    """Read until the peer closes (or a timeout fails the test).
    Returns the bytes read. A hang here = the attack wedged a thread."""
    sock.settimeout(timeout)
    got = b""
    try:
        while len(got) < max_bytes:
            chunk = sock.recv(65536)
            if not chunk:
                break
            got += chunk
    except socket.timeout:
        pytest.fail("server neither answered nor closed (hang)")
    except OSError:
        pass
    return got


def _read_http_response(sock, timeout=15):
    """Read one HTTP response (head + Content-Length body). The server
    may keep the connection alive after an error — a rejected
    handshake is an ANSWER, not a close."""
    sock.settimeout(timeout)
    head = b""
    try:
        while b"\r\n\r\n" not in head:
            chunk = sock.recv(65536)
            if not chunk:
                return head
            head += chunk
    except socket.timeout:
        pytest.fail("no HTTP response to the bad handshake (hang)")
    return head


def _assert_alive_and_clean(base, httpd, sid):
    """After every attack: server serves, no event-queue leak, and a
    WELL-BEHAVED WS cycle on the same session still works."""
    assert _get(base, "/health")["ok"]
    # hostile connections must not leave their fan-out queue behind
    t0 = time.time()
    while time.time() - t0 < 10:
        if len(httpd.state.event_queues.get(sid, [])) == 0:
            break
        time.sleep(0.1)
    assert len(httpd.state.event_queues.get(sid, [])) == 0

    from nobs_whisper_torch.serve.ws import client_connect
    sock = client_connect(base.replace("http", "ws")
                          + f"/sessions/{sid}/ws", timeout=60)
    try:
        sock.send_json({"verb": "cancel"})
        for _ in range(50):
            msg = sock.recv()
            assert msg is not None
            obj = json.loads(msg[1])
            if obj.get("reply") == "cancel":
                break
        else:
            pytest.fail("no cancel reply after attack")
    finally:
        sock.close()


# ---- hostile handshakes ---------------------------------------------------

def test_handshake_missing_key(session):
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        s.sendall((f"GET /sessions/{sid}/ws HTTP/1.1\r\n"
                   "Host: h\r\nUpgrade: websocket\r\n"
                   "Connection: Upgrade\r\n\r\n").encode())
        head = _read_http_response(s)
        assert b" 400" in head.split(b"\r\n")[0]
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_handshake_wrong_upgrade_header(session):
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        s.sendall((f"GET /sessions/{sid}/ws HTTP/1.1\r\n"
                   "Host: h\r\nUpgrade: tcp\r\n"
                   "Connection: Upgrade\r\n"
                   "Sec-WebSocket-Key: abc\r\n\r\n").encode())
        head = _read_http_response(s)
        assert b" 400" in head.split(b"\r\n")[0]
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_handshake_unknown_session_404(server):
    base, httpd = server
    s = _raw_connect(base)
    try:
        head = _handshake(s, "nonexistent0")
        assert b" 404" in head.split(b"\r\n")[0]
    finally:
        s.close()
    assert _get(base, "/health")["ok"]


def test_handshake_absurd_header_values(session):
    """A kilobyte of garbage in the key and junk headers: the server
    must either upgrade (the key is opaque per RFC) or reject — not
    crash."""
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        head = _handshake(s, sid, key="A" * 1024)
        status = head.split(b"\r\n")[0]
        assert (b"101" in status) or (b" 4" in status)
        s.close()
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


# ---- frame-level abuse ----------------------------------------------------

def test_truncated_masked_frame_then_disconnect(session):
    """Declare 4000 bytes, send 100, vanish. The reader must hit
    'connection closed mid-frame' and clean up."""
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        assert b"101" in _handshake(s, sid)
        frame = _masked_frame(0x2, b"\x00" * 4000)
        s.sendall(frame[:110])
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_length_field_lies(session):
    """64-bit length claims beyond MAX_FRAME (including 2^62) must be
    rejected BEFORE any payload is consumed; the connection closes."""
    base, httpd, sid = session
    for n_claim in (64 * 1024 * 1024 + 1, 1 << 40, 1 << 62):
        s = _raw_connect(base)
        try:
            assert b"101" in _handshake(s, sid)
            head = bytearray([0x80 | 0x2, 0x80 | 127])
            head += struct.pack(">Q", n_claim)
            head += b"\x00\x00\x00\x00"      # mask
            s.sendall(bytes(head))
            # no payload sent: server must close on its own
            _drain_until_closed(s)
        finally:
            s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_fragmented_message_over_cap(session):
    """Per-frame cap bypass via fragmentation: 32 MiB frames with
    fin=0 until the reassembled message crosses MAX_FRAME — the
    message cap must close the connection."""
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        assert b"101" in _handshake(s, sid)
        chunk = b"\x00" * (32 * 1024 * 1024)
        s.sendall(_masked_frame(0x2, chunk, fin=False))
        s.sendall(_masked_frame(0x0, chunk, fin=False))
        # third fragment pushes total past 64 MiB; server may close
        # mid-send — tolerate the broken pipe
        try:
            s.sendall(_masked_frame(0x0, chunk, fin=False))
            _drain_until_closed(s, timeout=30)
        except OSError:
            pass
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_continuation_without_start(session):
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        assert b"101" in _handshake(s, sid)
        s.sendall(_masked_frame(0x0, b"orphan continuation"))
        _drain_until_closed(s)
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_reserved_opcodes(session):
    base, httpd, sid = session
    for opcode in (0x3, 0x7, 0xB, 0xF):
        s = _raw_connect(base)
        try:
            assert b"101" in _handshake(s, sid)
            s.sendall(_masked_frame(opcode, b"xx"))
            _drain_until_closed(s)
        finally:
            s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_random_garbage_after_upgrade(session):
    """Raw random bytes as 'frames': whatever they parse as, the
    connection must end closed with the server healthy."""
    base, httpd, sid = session
    rng = np.random.default_rng(7)
    for seed in range(5):
        s = _raw_connect(base)
        try:
            assert b"101" in _handshake(s, sid)
            s.sendall(rng.bytes(4096))
            _drain_until_closed(s)
        except OSError:
            pass
        finally:
            s.close()
    _assert_alive_and_clean(base, httpd, sid)


# ---- protocol-level abuse -------------------------------------------------

def test_junk_json_verbs(session):
    """Non-JSON text, JSON non-objects, unknown verbs, nested junk:
    each gets a JSON error/refusal reply on the SOCKET (never an HTTP
    response), and the channel keeps working."""
    from nobs_whisper_torch.serve.ws import client_connect
    base, httpd, sid = session
    sock = client_connect(base.replace("http", "ws")
                          + f"/sessions/{sid}/ws", timeout=60)
    try:
        cases = [b"not json", b"[1,2,3]", b"42", b"null",
                 b'"string"', b'{"verb": "explode"}',
                 b'{"verb": null}', b'{"no_verb": 1}',
                 b'{"verb": {"nested": true}}',
                 "{'single': 'quotes'}".encode(),
                 b"\xff\xfe invalid utf8 \x80"]
        for payload in cases:
            sock._send_frame(0x1, payload)        # raw text frame
            msg = sock.recv()
            assert msg is not None, payload
            obj = json.loads(msg[1])
            assert "error" in obj, (payload, obj)
        # channel still does real work
        sock.send_json({"verb": "start"})
        for _ in range(50):
            obj = json.loads(sock.recv()[1])
            if obj.get("reply") == "start":
                assert obj["started"] in (True, False)
                break
        sock.send_json({"verb": "cancel"})
        for _ in range(50):
            obj = json.loads(sock.recv()[1])
            if obj.get("reply") == "cancel":
                break
    finally:
        sock.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_misaligned_pcm_binary(session):
    """Binary frames whose length isn't a multiple of 4 (truncated f32)
    get the bad-frame JSON reply, not an exception."""
    from nobs_whisper_torch.serve.ws import client_connect
    base, httpd, sid = session
    sock = client_connect(base.replace("http", "ws")
                          + f"/sessions/{sid}/ws", timeout=60)
    try:
        for n in (1, 2, 3, 5, 4001):
            sock.send_binary(b"\x01" * n)
            obj = json.loads(sock.recv()[1])
            assert obj.get("error") == "bad frame", (n, obj)
    finally:
        sock.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_ping_flood_interleaved_with_fragments(session):
    """Control frames interleaved inside a fragmented message are legal
    (RFC 6455 §5.4) — the server must answer the pings and still
    reassemble the message. Crafted at raw-socket level for fin
    control."""
    base, httpd, sid = session
    verb = json.dumps({"verb": "cancel"}).encode()
    s = _raw_connect(base)
    try:
        assert b"101" in _handshake(s, sid)
        s.sendall(_masked_frame(0x1, verb[:5], fin=False))
        for _ in range(20):
            s.sendall(_masked_frame(0x9, b"ping!"))   # interleaved pings
        s.sendall(_masked_frame(0x0, verb[5:], fin=True))
        # expect 20 pongs + the cancel reply somewhere in the stream
        s.settimeout(20)
        got = b""
        t0 = time.time()
        while b'"reply": "cancel"' not in got \
                and b'"reply":"cancel"' not in got:
            if time.time() - t0 > 20:
                pytest.fail(f"no cancel reply; got {got[:200]!r}")
            got += s.recv(65536)
        assert got.count(b"ping!") >= 20      # pongs echo the payload
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)


def test_abrupt_disconnect_mid_recording(session):
    """RST mid-session while recording: the pump thread and queue must
    clean up; the session survives (it belongs to the HTTP surface,
    not the socket) and a new WS cycle finishes the recording."""
    base, httpd, sid = session
    s = _raw_connect(base)
    try:
        assert b"101" in _handshake(s, sid)
        s.sendall(_masked_frame(0x1, b'{"verb": "start"}'))
        audio = (np.random.RandomState(0).randn(8000) * 0.2
                 ).astype("<f4").tobytes()
        s.sendall(_masked_frame(0x2, audio))
        # vanish without close frame, with RST (SO_LINGER 0)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
    finally:
        s.close()
    _assert_alive_and_clean(base, httpd, sid)
    # the session is still functional over HTTP
    out = _post(base, f"/sessions/{sid}/stop")
    assert "state" in out
