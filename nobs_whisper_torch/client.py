"""Python client SDK for the serving API (port of the JAX package's
``client.py``; it speaks to either package's server).

The reference's client surface is its Svelte settings SPA driving the 14
Tauri IPC commands (src/routes/+page.svelte:133-185 → src-tauri/src/
lib.rs:117-134). Our serving layer exposes those capabilities over HTTP
(serve/server.py) plus a built-in web client (serve/webui.py); this
module is the *programmatic* client — a typed, dependency-free (stdlib
urllib) SDK so the full surface is drivable from Python code: config
get/set, the 13-model registry with background downloads + progress
polling (model.rs:208-324 semantics), one-shot transcription with
decode-strategy overrides, and streaming sessions with the push-to-talk
verb set (press/release/toggle/cancel, native_shortcut.rs:356-396
analog) and the SSE event stream standing in for the indicator
(recording/processing/done, indicator.rs:149-185).

Usage::

    from nobs_whisper_torch.client import Client

    c = Client("http://127.0.0.1:8777")
    print(c.transcribe("meeting.wav", language="en")["text"])

    with c.session(language="en") as s:
        s.start()
        s.push_audio(samples)           # float32 PCM, session rate
        for ev in s.events():           # SSE: partial transcripts
            print(ev.state, ev.transcript)
            if ev.is_final:
                break
"""

from __future__ import annotations

import dataclasses
import io
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Client", "ClientError", "Session", "SessionEvent"]


class ClientError(Exception):
    """HTTP-level failure; carries the server's error envelope."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


@dataclasses.dataclass
class SessionEvent:
    """Mirror of pipeline.session.SessionEvent as it rides the SSE wire."""

    state: str
    transcript: Optional[str] = None
    is_final: bool = False


def _wav_bytes(audio, sample_rate: int) -> bytes:
    """Encode float32 PCM [-1, 1] as a 16-bit mono WAV blob (the
    shared audio.io encoder, so SDK round-trips match the rest of the
    codebase bit for bit — incl. its clip-before-scale behavior)."""
    from .audio.io import write_wav

    buf = io.BytesIO()
    write_wav(buf, audio, sample_rate)
    return buf.getvalue()


class Client:
    """Stdlib HTTP client for a ``nobs_whisper_torch.cli serve`` endpoint
    (or the JAX package's, and its multi-host router, which relays every
    verb the SDK uses)."""

    def __init__(self, base_url: str = "http://127.0.0.1:8777",
                 timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ---- plumbing ------------------------------------------------------
    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None):
        req = urllib.request.Request(self.base_url + path, data=body,
                                     method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout) as resp:
                return resp.status, resp.read(), \
                    resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                msg = json.loads(raw).get("error", raw.decode("utf-8",
                                                              "replace"))
                if isinstance(msg, dict):   # OpenAI-style envelope
                    msg = msg.get("message", str(msg))
            except Exception:
                msg = raw.decode("utf-8", "replace")
            raise ClientError(e.code, msg) from None

    def _json(self, method: str, path: str, obj: Any = None,
              timeout: Optional[float] = None):
        body = json.dumps(obj).encode() if obj is not None else None
        _, raw, _ = self._request(method, path, body, timeout=timeout)
        return json.loads(raw)

    # ---- status --------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        return self._json("GET", "/health")

    def state(self) -> Dict[str, str]:
        """All live sessions' states (the get_app_state analog,
        state.rs:213)."""
        return self._json("GET", "/state")

    def stats(self) -> Dict[str, Any]:
        return self._json("GET", "/stats")

    # ---- config (config.rs:110-115 analog) ------------------------------
    def get_config(self) -> Dict[str, Any]:
        return self._json("GET", "/config")

    def set_config(self, **fields) -> Dict[str, Any]:
        """Read-modify-write: merge ``fields`` into the persisted config
        (set_config applies side effects server-side — model hot-swap —
        matching config.rs:127-164)."""
        cfg = self.get_config()
        cfg.update(fields)
        return self._json("POST", "/config", cfg)

    # ---- model registry (model.rs:208-338 analog) ------------------------
    def models(self) -> List[Dict[str, Any]]:
        return self._json("GET", "/models")

    def download_model(self, model_id: str, wait: bool = False,
                       poll_s: float = 0.5,
                       timeout_s: float = 3600.0) -> Optional[float]:
        """Start a background download; with ``wait`` poll progress
        (the UI's 500 ms loop, +page.svelte:106-119) until it leaves the
        in-flight map. Returns the last observed progress %."""
        self._json("POST", f"/models/{model_id}/download")
        if not wait:
            return None
        last, deadline = 0.0, time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            p = self.download_progress(model_id)
            if p is None:   # left the progress map: finished or failed
                status = {m["id"]: m["status"] for m in self.models()}
                if status.get(model_id) != "downloaded":
                    raise ClientError(0, f"download of {model_id} failed")
                return last
            last = p
            time.sleep(poll_s)
        raise ClientError(0, f"download of {model_id} timed out")

    def download_progress(self, model_id: str) -> Optional[float]:
        return self._json("GET",
                          f"/models/{model_id}/progress")["progress"]

    def delete_model(self, model_id: str) -> bool:
        return self._json("DELETE", f"/models/{model_id}")["deleted"]

    # ---- one-shot transcription ----------------------------------------
    def transcribe(self, audio, sample_rate: int = 16000,
                   language: Optional[str] = None,
                   task: Optional[str] = None,
                   vocabulary: Optional[str] = None,
                   context: Optional[str] = None,
                   beam_size: Optional[int] = None,
                   best_of: Optional[int] = None,
                   temperature: Optional[float] = None,
                   word_timestamps: bool = False,
                   format: str = "json"):
        """POST /transcribe. ``audio`` is a path to a WAV file, WAV
        bytes, or a float32 array at ``sample_rate``. ``format="json"``
        returns the parsed dict; srt/vtt/txt/tsv return the rendered
        text (the CLI's --output-format set, utils/writers.py)."""
        if isinstance(audio, str):
            with open(audio, "rb") as f:
                body = f.read()
            if body[:4] != b"RIFF":
                raise ValueError(f"{audio} is not a WAV file")
        elif isinstance(audio, (bytes, bytearray)):
            body = bytes(audio)
        else:
            body = _wav_bytes(audio, sample_rate)

        params = {k: v for k, v in {
            "language": language, "task": task, "vocabulary": vocabulary,
            "context": context, "beam_size": beam_size, "best_of": best_of,
            "temperature": temperature,
            "word_timestamps": "1" if word_timestamps else None,
            "format": format if format != "json" else None,
            "sample_rate": (sample_rate if body[:4] != b"RIFF"
                            and sample_rate != 16000 else None),
        }.items() if v is not None}
        path = "/transcribe"
        if params:
            path += "?" + urllib.parse.urlencode(params)
        _, raw, _ = self._request("POST", path, body)
        return json.loads(raw) if format == "json" else raw.decode("utf-8")

    # ---- streaming sessions ---------------------------------------------
    def session(self, **opts) -> "Session":
        """Create a streaming session (state.rs lifecycle analog).
        Accepts SessionConfig fields: language, vocabulary, sample_rate,
        max_duration_s, beam_size, best_of, temperature, task."""
        sid = self._json("POST", "/sessions", opts or {})["session"]
        return Session(self, sid)


class Session:
    """Handle to one server-side StreamingSession. Usable as a context
    manager — exit deletes the session server-side."""

    def __init__(self, client: Client, sid: str):
        self.client = client
        self.id = sid

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.delete()
        except ClientError:
            pass

    def _verb(self, verb: str) -> Dict[str, Any]:
        return self.client._json("POST", f"/sessions/{self.id}/{verb}")

    def start(self) -> bool:
        return self._verb("start")["started"]

    def stop(self) -> Optional[str]:
        """Blocking stop; returns the final transcript
        (stop_recording_with_app analog, state.rs:655)."""
        return self._verb("stop")["transcript"]

    def toggle(self) -> bool:
        return self._verb("toggle")["recording"]

    def cancel(self) -> None:
        self._verb("cancel")

    def press(self) -> Dict[str, Any]:
        """Hotkey press: starts (push-to-talk config) or toggles."""
        return self._verb("press")

    def release(self) -> Dict[str, Any]:
        return self._verb("release")

    def state(self) -> str:
        return self.client.state()[self.id]

    def push_audio(self, samples) -> None:
        """Push float32 PCM at the session's configured sample rate
        (the cpal callback analog, state.rs:585-607)."""
        import numpy as np

        body = np.asarray(samples, np.float32).astype("<f4").tobytes()
        self.client._request("POST", f"/sessions/{self.id}/audio", body)

    def websocket(self, timeout: float = 300.0):
        """Open the session's full-duplex WebSocket channel (the
        single-channel Tauri-IPC analog, lib.rs:117-134 + state.rs:453):
        send binary frames of little-endian f32 PCM, send JSON verb
        frames ({"verb": "start"|...}), receive JSON replies and session
        events. Returns a ``serve.ws.ClientWebSocket``."""
        from .serve import ws as wsmod

        url = (self.client.base_url.replace("http://", "ws://", 1)
               + f"/sessions/{self.id}/ws")
        return wsmod.client_connect(url, timeout=timeout)

    def events(self, timeout: Optional[float] = None
               ) -> Iterator[SessionEvent]:
        """Yield SSE events until the final one (done/cancelled). The
        subscription is live when this RETURNS (the connection opens
        eagerly, not at the first ``next()``), so events fired by a
        subsequent start() are never missed. The server closes the
        stream after the final event; keepalive comments are skipped."""
        req = urllib.request.Request(
            f"{self.client.base_url}/sessions/{self.id}/events")
        resp = urllib.request.urlopen(
            req, timeout=timeout or self.client.timeout)
        return self._read_events(resp)

    @staticmethod
    def _read_events(resp) -> Iterator[SessionEvent]:
        try:
            for line in resp:
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                d = json.loads(line[len(b"data: "):])
                ev = SessionEvent(state=d["state"],
                                  transcript=d.get("transcript"),
                                  is_final=bool(d.get("is_final")))
                yield ev
                if ev.is_final or ev.state == "cancelled":
                    return
        finally:
            resp.close()

    def delete(self) -> bool:
        return self.client._json(
            "DELETE", f"/sessions/{self.id}")["deleted"]
