"""Minimal RFC 6455 WebSocket endpoint (pure stdlib; port of the JAX
package's ``serve/ws.py``).

The reference's client transport is Tauri IPC: bidirectional in one
channel — commands in (`invoke`, src-tauri/src/lib.rs:117-134), events
out (`state-changed`, src-tauri/src/state.rs:453). The HTTP surface
splits that into POST verbs + an SSE stream; this module restores the
single full-duplex channel for live dictation over the network: one
socket carries f32 PCM audio up (binary frames), session verbs up (JSON
text frames), and session events down (JSON text frames).

Server side only needs: the 101 handshake (Sec-WebSocket-Accept =
base64(sha1(key + GUID))), client-masked frame decode, unmasked frame
encode, ping/pong, close. No extensions, no fragmentation support
beyond continuation reassembly, no permessage-deflate — deliberately
tiny and auditable.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# opcodes
OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

MAX_FRAME = 64 * 1024 * 1024   # 64 MiB: > any sane audio push


class WebSocketError(Exception):
    pass


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def is_upgrade_request(headers) -> bool:
    return ("upgrade" in headers.get("Connection", "").lower()
            and headers.get("Upgrade", "").lower() == "websocket"
            and headers.get("Sec-WebSocket-Key") is not None)


class WebSocket:
    """One accepted server-side connection over the handler's buffered
    rfile/wfile. Writes are lock-guarded so an event-pusher thread and
    the verb-reply path can share the socket."""

    def __init__(self, rfile, wfile):
        self._r = rfile
        self._w = wfile
        self._wlock = threading.Lock()
        self.closed = False

    # ---- encode ---------------------------------------------------------
    def _send_frame(self, opcode: int, payload: bytes) -> None:
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(n)
        elif n < (1 << 16):
            head.append(126)
            head += struct.pack(">H", n)
        else:
            head.append(127)
            head += struct.pack(">Q", n)
        with self._wlock:
            if self.closed:
                raise WebSocketError("closed")
            self._w.write(bytes(head) + payload)
            self._w.flush()

    def send_text(self, text: str) -> None:
        self._send_frame(OP_TEXT, text.encode("utf-8"))

    def send_json(self, obj) -> None:
        self.send_text(json.dumps(obj))

    def send_binary(self, data: bytes) -> None:
        self._send_frame(OP_BINARY, data)

    def close(self, code: int = 1000) -> None:
        if not self.closed:
            try:
                self._send_frame(OP_CLOSE, struct.pack(">H", code))
            except Exception:
                pass
            self.closed = True

    # ---- decode ---------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._r.read(n - len(buf))
            if not chunk:
                raise WebSocketError("connection closed mid-frame")
            buf += chunk
        return buf

    def _read_frame(self) -> Tuple[int, bool, bytes]:
        b0, b1 = self._read_exact(2)
        fin = bool(b0 & 0x80)
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack(">H", self._read_exact(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", self._read_exact(8))
        if n > MAX_FRAME:
            raise WebSocketError(f"frame too large ({n} bytes)")
        mask = self._read_exact(4) if masked else None
        payload = self._read_exact(n)
        if mask:
            payload = _unmask(payload, mask)
        return opcode, fin, payload

    def recv(self) -> Optional[Tuple[int, bytes]]:
        """Next data message as (opcode, payload), reassembling
        continuations; answers pings; returns None on close."""
        msg_op, parts, total = None, [], 0
        while True:
            opcode, fin, payload = self._read_frame()
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self.close()
                return None
            if opcode in (OP_TEXT, OP_BINARY):
                msg_op, parts, total = opcode, [payload], len(payload)
            elif opcode == OP_CONT and msg_op is not None:
                parts.append(payload)
                total += len(payload)
            else:
                raise WebSocketError(f"unexpected opcode {opcode:#x}")
            if total > MAX_FRAME:
                # the per-frame cap in _read_frame is trivially
                # bypassed by fragmentation — bound the reassembled
                # MESSAGE too or one connection can grow without limit
                raise WebSocketError("message too large")
            if fin:
                return msg_op, b"".join(parts)


def _unmask(payload: bytes, mask: bytes) -> bytes:
    # XOR with the repeated 4-byte mask, vectorized via int.from_bytes
    # (C-speed for the multi-KB audio frames this endpoint carries)
    n = len(payload)
    if n == 0:
        return payload
    reps = (n + 3) // 4
    key = int.from_bytes(mask * reps, "big") >> (8 * (reps * 4 - n))
    return (int.from_bytes(payload, "big") ^ key).to_bytes(n, "big")


def upgrade(handler) -> WebSocket:
    """Complete the 101 handshake on a BaseHTTPRequestHandler and hand
    back the framed socket. The caller owns the connection afterwards
    (handler.close_connection is forced on)."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key:
        raise WebSocketError("missing Sec-WebSocket-Key")
    handler.close_connection = True
    w = handler.wfile
    w.write(b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\n"
            b"Connection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + accept_key(key).encode()
            + b"\r\n\r\n")
    w.flush()
    return WebSocket(handler.rfile, handler.wfile)


# ---- client side (used by client.py and the tests) -----------------------

def client_connect(url: str, timeout: float = 300.0) -> "ClientWebSocket":
    """Open a client WebSocket to ws://host:port/path (stdlib socket)."""
    import os
    import socket
    from urllib.parse import urlsplit

    u = urlsplit(url)
    if u.scheme not in ("ws", "http"):
        raise WebSocketError(f"unsupported scheme {u.scheme!r}")
    sock = socket.create_connection((u.hostname, u.port or 80),
                                    timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    req = (f"GET {path} HTTP/1.1\r\n"
           f"Host: {u.hostname}:{u.port or 80}\r\n"
           "Upgrade: websocket\r\n"
           "Connection: Upgrade\r\n"
           f"Sec-WebSocket-Key: {key}\r\n"
           "Sec-WebSocket-Version: 13\r\n\r\n")
    sock.sendall(req.encode())
    f = sock.makefile("rb")
    status = f.readline()
    if b"101" not in status:
        # read the error response without hanging on keep-alive: headers,
        # then exactly Content-Length body bytes
        body = b""
        try:
            clen = 0
            while True:
                line = f.readline()
                if line in (b"\r\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    clen = int(value)
            if clen:
                body = f.read(min(clen, 2048))
        except Exception:
            pass
        sock.close()
        raise WebSocketError(
            f"handshake rejected: {status!r} {body[:200]!r}")
    expect = accept_key(key)
    ok = False
    while True:
        line = f.readline()
        if line in (b"\r\n", b""):
            break
        name, _, value = line.decode().partition(":")
        if name.strip().lower() == "sec-websocket-accept" \
                and value.strip() == expect:
            ok = True
    if not ok:
        sock.close()
        raise WebSocketError("bad Sec-WebSocket-Accept")
    return ClientWebSocket(sock, f)


class ClientWebSocket(WebSocket):
    """Client side: frames are masked on send (RFC 6455 §5.3)."""

    def __init__(self, sock, rfile):
        self._sock = sock
        super().__init__(rfile, sock.makefile("wb"))

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        import os
        mask = os.urandom(4)
        head = bytearray([0x80 | opcode])
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
        with self._wlock:
            if self.closed:
                raise WebSocketError("closed")
            self._w.write(bytes(head) + _unmask(payload, mask))
            self._w.flush()

    def close(self, code: int = 1000) -> None:
        super().close(code)
        try:
            self._sock.close()
        except Exception:
            pass
