"""HTTP session-control API.

Replaces the reference's Tauri IPC surface (14 invoke commands,
src-tauri/src/lib.rs:117-134) and its hotkey/indicator UX with network
verbs: config get/set, model registry/downloads, session lifecycle
(start/stop/toggle/cancel = the push-to-talk semantics), raw-PCM audio
push, one-shot transcription, and an SSE event stream standing in for the
floating indicator (recording/processing/done states,
src-tauri/src/indicator.rs).

Pure stdlib (ThreadingHTTPServer) — no web framework dependency. Port of
the JAX package's ``serve/server.py``: the same routes, bodies and errors
over the port's engines. Beam search (``?beam_size=``, a session's
``beam_size``, the configured ``beam_size``) is served; a decode strategy
the port lacks (word timestamps) raises ``NotImplementedError`` in the
engine, which the routes answer with their 500 JSON error.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..api import NoModelError
from ..pipeline.session import SessionConfig, SessionEvent, StreamingSession
from .config import AppConfig, ConfigManager
from . import models as model_registry

log = logging.getLogger(__name__)


def rss_mb() -> float:
    """This process's resident set, MB (0.0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class DrainingError(RuntimeError):
    """New-session creation refused: this backend is draining for a
    restart (the RSS watermark fired, or the router asked)."""


class ServerState:
    """Shared state behind the handlers."""

    def __init__(self, engine, config_manager: Optional[ConfigManager] = None,
                 engine_factory=None):
        self.engine = engine
        self.config_manager = config_manager or ConfigManager()
        self.sessions: Dict[str, StreamingSession] = {}
        self.event_queues: Dict[str, list] = {}   # session -> [queue, ...]
        self._lock = threading.Lock()
        # live model hot-swap (config.rs:138-164): when the CLI supplies
        # an engine factory (model_id -> ready engine, mirroring its own
        # startup construction incl. quantization/batching/audio_ctx),
        # a /config change of selected_model rebuilds and swaps the
        # serving engine. New sessions and one-shots use the new model;
        # the old engine is drained and closed.
        self._engine_factory = engine_factory
        if engine_factory is not None:
            self.config_manager.set_engine_provider(self._hot_swap)
        # engines displaced by a hot-swap but still referenced by live
        # sessions or in-flight one-shots; closed (drained) once the
        # last reference is gone, so a swap never strands an in-flight
        # transcription on a dead batcher queue
        self._retired: list = []
        self._borrows: Dict[int, int] = {}   # id(engine) -> count
        # rolling-restart support (a backend whose host RSS grows past
        # its watermark must drain + restart before the host runs out;
        # a router orchestrates, serve self-reports):
        # draining=True refuses NEW sessions (503) while existing
        # sessions and one-shots keep working until they finish.
        self.draining = False
        self.rss_watermark_mb = 0.0

    def _hot_swap(self, model_id: str) -> None:
        new = self._engine_factory(model_id)
        with self._lock:
            old, self.engine = self.engine, new
            if old is new or old is None:
                # old is None = model-less first launch (lib.rs:26-42
                # analog: serve starts unloaded, the first selection
                # builds the engine) — nothing to retire
                return
            self._retired.append(old)
            to_close = self._collect_unreferenced_locked()
        self._close_engines(to_close)

    def _collect_unreferenced_locked(self) -> list:
        """Split self._retired into still-referenced (kept) and
        closeable (returned). Caller holds self._lock and closes the
        returned engines OUTSIDE the lock (close drains, which can
        block on device work)."""
        live = {id(s.engine) for s in self.sessions.values()}
        live.update(eid for eid, n in self._borrows.items() if n > 0)
        keep, close = [], []
        for eng in self._retired:
            (keep if id(eng) in live else close).append(eng)
        self._retired = keep
        return close

    @staticmethod
    def _close_engines(engines) -> None:
        for eng in engines:
            close = getattr(eng, "close", None)
            if close is not None:
                close()   # BatchedEngine.close() drains its queue first

    def reap_retired(self) -> None:
        """Close retired engines that lost their last reference."""
        with self._lock:
            to_close = self._collect_unreferenced_locked()
        self._close_engines(to_close)

    def borrow_engine(self):
        """Context manager pinning the current engine for a one-shot
        transcription: a concurrent hot-swap retires but does not close
        it until the borrow ends."""
        import contextlib

        @contextlib.contextmanager
        def _borrow():
            with self._lock:
                eng = self.engine
                if eng is None:
                    raise NoModelError(
                        "no model loaded; select one via POST /config "
                        '{"selected_model": ...} or the web UI')
                self._borrows[id(eng)] = self._borrows.get(id(eng), 0) + 1
            try:
                yield eng
            finally:
                with self._lock:
                    n = self._borrows.get(id(eng), 1) - 1
                    if n:
                        self._borrows[id(eng)] = n
                    else:
                        self._borrows.pop(id(eng), None)
                    to_close = self._collect_unreferenced_locked()
                self._close_engines(to_close)
        return _borrow()

    def create_session(self, cfg: SessionConfig) -> str:
        sid = uuid.uuid4().hex[:12]

        def fanout(event: SessionEvent):
            with self._lock:
                queues = list(self.event_queues.get(sid, []))
            for q in queues:
                q.put(event)

        # construct AND register under one lock hold (construction is
        # cheap — no device work): the engine snapshot and the session's
        # visibility to _collect_unreferenced_locked are atomic, so a
        # concurrent hot-swap can never close the engine this session
        # just picked up
        with self._lock:
            if self.draining:
                raise DrainingError(
                    "backend draining for restart; retry shortly "
                    "(the router places new sessions elsewhere)")
            if self.engine is None:
                raise NoModelError(
                    "no model loaded; select one via POST /config "
                    '{"selected_model": ...} or the web UI')
            session = StreamingSession(self.engine, cfg, on_event=fanout)
            self.sessions[sid] = session
            self.event_queues[sid] = []
        return sid

    def subscribe(self, sid: str) -> "queue.Queue[SessionEvent]":
        q: "queue.Queue[SessionEvent]" = queue.Queue()
        with self._lock:
            # atomic with session existence: a subscribe racing the
            # session's DELETE would otherwise setdefault a fresh
            # event_queues entry for a dead session and leak it
            # forever (found by the soak's hostile-WS worker)
            if sid not in self.sessions:
                raise KeyError(f"no session {sid}")
            self.event_queues.setdefault(sid, []).append(q)
        return q

    def unsubscribe(self, sid: str, q) -> None:
        with self._lock:
            try:
                self.event_queues.get(sid, []).remove(q)
            except ValueError:
                pass


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        # ---- helpers -------------------------------------------------
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, msg, code=400):
            self._json({"error": msg}, code)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _guarded(self, fn):
            """Map handler exceptions to HTTP instead of dropping the
            connection: KeyError (unknown model/session id) -> 404,
            ValueError (bad input) -> 400, anything else -> 500."""
            try:
                return fn()
            except KeyError as e:
                return self._error(str(e), 404)
            except NoModelError as e:
                # model-less launch: transcription verbs 409 until the
                # first selection builds an engine (lib.rs:26-42)
                return self._error(str(e), 409)
            except ValueError as e:
                return self._error(str(e), 400)
            except Exception as e:
                log.exception("request failed")
                return self._error(str(e), 500)

        # ---- GET -----------------------------------------------------
        def do_GET(self):
            return self._guarded(self._do_get)

        def _do_get(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if not parts or parts == ["index.html"]:
                # built-in web client (the reference's settings SPA
                # analog, src/routes/+page.svelte)
                from .webui import INDEX_HTML
                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["v1", "models"]:
                from . import openai_compat
                return self._json(openai_compat.models_listing(state))
            if parts == ["health"]:
                return self._json({
                    "ok": True,
                    "model": getattr(state.engine, "model_path", None),
                    "loaded": (state.engine is not None
                               and getattr(state.engine, "loaded", True)),
                    "draining": state.draining})
            if parts == ["config"]:
                return self._json(state.config_manager.config.to_dict())
            if parts == ["models"]:
                return self._json([dataclasses.asdict(m)
                                   for m in model_registry.list_models()])
            if len(parts) == 3 and parts[0] == "models" \
                    and parts[2] == "progress":
                return self._json({
                    "progress":
                        model_registry.get_download_progress(parts[1]),
                    "error":
                        model_registry.get_download_error(parts[1])})
            if parts == ["state"]:
                return self._json({
                    sid: s.state.value for sid, s in state.sessions.items()})
            if parts == ["stats"]:
                from ..utils.profiling import GLOBAL_PROFILER
                out = {"stages": GLOBAL_PROFILER.snapshot()}
                # restart-planning gauges: a router watches rss_mb
                # against the watermark and rolls the backend before
                # the host runs out
                out["host"] = {
                    "rss_mb": round(rss_mb(), 1),
                    "rss_watermark_mb": state.rss_watermark_mb,
                    "draining": state.draining,
                    "sessions": len(state.sessions),
                }
                if hasattr(state.engine, "chunk_count"):
                    # fallback-ladder attribution: each retry is a full
                    # batched window decode (BatchedEngine counters)
                    out["decode"] = {
                        "chunks": state.engine.chunk_count,
                        "fallback_retries": state.engine.fallback_retries,
                        "tokens_emitted": state.engine.tokens_emitted,
                    }
                batcher = getattr(state.engine, "batcher", None)
                if batcher is not None:
                    sizes = batcher.batch_sizes[-100:]
                    out["batcher"] = {
                        "recent_batches": len(sizes),
                        "mean_batch": (sum(sizes) / len(sizes)
                                       if sizes else 0.0),
                        "max_batch": max(sizes, default=0),
                        "watchdog_trips": getattr(batcher,
                                                  "watchdog_trips", 0),
                        # host->device payload bytes since start
                        "transferred_mb": round(
                            getattr(batcher, "transferred_bytes", 0)
                            / 1e6, 1),
                    }
                    # queue_wait_ms (p50, p95 over the recent batches'
                    # rows) and step_ms (host ms a decode step by part)
                    out["batcher"].update(GLOBAL_PROFILER.batch_summary())
                    sp = getattr(batcher, "spec_stats", [])[-100:]
                    if sp:
                        # emitted tokens per (pass x row): the
                        # speculative acceptance rate as served
                        passes_rows = sum(p * rows for p, rows, _ in sp)
                        emitted = sum(e for _, _, e in sp)
                        out["batcher"]["speculative"] = {
                            "recent_batches": len(sp),
                            "emitted_per_pass": round(
                                emitted / max(passes_rows, 1), 3),
                        }
                return self._json(out)
            if len(parts) == 3 and parts[0] == "sessions" \
                    and parts[2] == "events":
                return self._sse_events(parts[1])
            if len(parts) == 3 and parts[0] == "sessions" \
                    and parts[2] == "ws":
                return self._websocket(parts[1])
            self._error("not found", 404)

        def _websocket(self, sid: str):
            """Full-duplex session channel (the Tauri-IPC analog,
            lib.rs:117-134 + state.rs:453 in ONE socket): binary frames
            = f32 LE PCM pushed to the session; JSON text frames =
            verbs ({"verb": "start"|"stop"|"toggle"|"cancel"|"press"|
            "release"}, each answered with a JSON reply); session
            events stream down as JSON text frames ({"event": ...})."""
            from . import ws as wsmod
            s = state.sessions.get(sid)
            if s is None:
                return self._error(f"no session {sid}", 404)
            if not wsmod.is_upgrade_request(self.headers):
                return self._error("expected a websocket upgrade", 400)
            sock = wsmod.upgrade(self)
            try:
                q = state.subscribe(sid)
            except KeyError:
                # the session was deleted between the existence check
                # and the subscribe; we're already in RFC 6455 land, so
                # answer on the SOCKET (a raised KeyError would make
                # _guarded write HTTP 404 into the upgraded stream)
                sock.send_json({"error": f"no session {sid}"})
                sock.close()
                return
            stop_pump = threading.Event()

            def pump_events():
                # persistent channel: unlike the SSE stream (one
                # recording lifecycle per connection, by contract), the
                # WS socket outlives final events — keep pumping so a
                # restarted session's next cycle streams too
                while not stop_pump.is_set():
                    try:
                        ev = q.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    try:
                        sock.send_json(
                            {"event": dataclasses.asdict(ev)})
                    except Exception:
                        return

            pump = threading.Thread(target=pump_events, daemon=True)
            pump.start()
            try:
                while True:
                    msg = sock.recv()
                    if msg is None:
                        break
                    opcode, payload = msg
                    if opcode == wsmod.OP_BINARY:
                        if len(payload) % 4:
                            # truncated f32 PCM must get the same JSON
                            # error the text path gets — an escaping
                            # ValueError would make _guarded write an
                            # HTTP response into the upgraded socket
                            sock.send_json({"error": "bad frame"})
                            continue
                        s.push_audio(np.frombuffer(payload, "<f4"))
                        if s.over_duration_cap():
                            s.stop(wait=False)
                        continue
                    try:
                        verb = json.loads(payload.decode()).get("verb")
                    except Exception:
                        sock.send_json({"error": "bad frame"})
                        continue
                    if verb == "start":
                        sock.send_json({"reply": verb,
                                        "started": s.start(),
                                        "state": s.state.value})
                    elif verb == "stop":
                        text = s.stop(wait=True)
                        sock.send_json({"reply": verb,
                                        "transcript": text,
                                        "state": s.state.value})
                    elif verb == "toggle":
                        sock.send_json({"reply": verb,
                                        "recording": s.toggle(),
                                        "state": s.state.value})
                    elif verb == "cancel":
                        s.cancel()
                        sock.send_json({"reply": verb,
                                        "state": s.state.value})
                    elif verb in ("press", "release"):
                        ptt = state.config_manager.config.push_to_talk
                        if verb == "press":
                            if ptt:
                                s.start()
                            else:
                                s.toggle()
                        elif ptt:
                            s.stop(wait=False)
                        sock.send_json({"reply": verb,
                                        "state": s.state.value})
                    else:
                        sock.send_json(
                            {"error": f"unknown verb {verb!r}"})
            except (wsmod.WebSocketError, BrokenPipeError,
                    ConnectionResetError, OSError):
                pass
            except Exception:
                # after the upgrade NOTHING may write HTTP into this
                # socket (_guarded would answer 400 in RFC 6455 land)
                log.exception("websocket session handler failed")
            finally:
                stop_pump.set()
                state.unsubscribe(sid, q)
                sock.close()

        def _sse_events(self, sid: str):
            if sid not in state.sessions:
                return self._error(f"no session {sid}", 404)
            q = state.subscribe(sid)
            # the stream has no Content-Length/chunking: the connection
            # itself delimits it, so keep-alive must be off or a
            # conformant client waits forever after the final event
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                while True:
                    try:
                        ev = q.get(timeout=15)
                    except queue.Empty:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    payload = json.dumps(dataclasses.asdict(ev))
                    self.wfile.write(f"data: {payload}\n\n".encode())
                    self.wfile.flush()
                    if ev.is_final or ev.state == "cancelled":
                        break
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                state.unsubscribe(sid, q)

        # ---- POST ----------------------------------------------------
        def do_POST(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            try:
                if parts == ["drain"] or parts == ["undrain"]:
                    # router-orchestrated rolling restart: drain stops
                    # NEW session placement here (existing sessions and
                    # one-shots run to completion); undrain re-opens
                    # (tests / operator abort of a planned restart)
                    state.draining = parts == ["drain"]
                    log.info("draining" if state.draining
                             else "drain cleared")
                    return self._json({"draining": state.draining,
                                       "sessions": len(state.sessions)})
                if parts == ["config"]:
                    new = AppConfig.from_dict(json.loads(self._body()))
                    state.config_manager.set_config(new)
                    return self._json(new.to_dict())
                if parts == ["transcribe"]:
                    return self._transcribe()
                if parts == ["v1", "audio", "transcriptions"]:
                    from . import openai_compat
                    return openai_compat.handle_audio(
                        self, state, "transcribe")
                if parts == ["v1", "audio", "translations"]:
                    from . import openai_compat
                    return openai_compat.handle_audio(
                        self, state, "translate")
                if parts == ["sessions"]:
                    return self._create_session()
                if len(parts) == 3 and parts[0] == "sessions":
                    return self._session_verb(parts[1], parts[2])
                if len(parts) == 3 and parts[0] == "models" \
                        and parts[2] == "download":
                    # validate BEFORE detaching: an unknown id or a
                    # duplicate download must be an HTTP error the
                    # client sees, not a stderr line in a dead thread
                    mid = parts[1]
                    if not any(m.id == mid
                               for m in model_registry.list_models()):
                        return self._error(f"unknown model {mid!r}", 404)
                    if model_registry.get_download_progress(mid) \
                            is not None:
                        return self._error(
                            f"{mid} is already downloading", 409)

                    def dl():
                        try:
                            model_registry.download_model(mid)
                        except Exception:
                            log.exception("download of %s failed", mid)

                    threading.Thread(target=dl, daemon=True).start()
                    return self._json({"started": mid})
            except DrainingError as e:
                # 503 + Retry-After: the canonical "try again shortly"
                return self._error(str(e), 503)
            except NoModelError as e:
                return self._error(str(e), 409)
            except ValueError as e:
                # bad input (e.g. an unknown task in /config) is the
                # client's fault, not a server failure
                return self._error(str(e), 400)
            except Exception as e:
                log.exception("request failed")
                return self._error(str(e), 500)
            self._error("not found", 404)

        def do_DELETE(self):
            return self._guarded(self._do_delete)

        def _do_delete(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if len(parts) == 2 and parts[0] == "models":
                return self._json(
                    {"deleted": model_registry.delete_model(parts[1])})
            if len(parts) == 2 and parts[0] == "sessions":
                s = state.sessions.pop(parts[1], None)
                # drop the SSE fan-out queues too, or abandoned sessions
                # leak an event_queues entry forever
                state.event_queues.pop(parts[1], None)
                if s:
                    s.cancel()
                    # this may have been the last reference to a
                    # hot-swap-retired engine
                    state.reap_retired()
                return self._json({"deleted": s is not None})
            self._error("not found", 404)

        def _query(self) -> Dict[str, str]:
            from urllib.parse import parse_qsl, urlsplit
            # keep blank values: ?vocabulary= is an explicit "no
            # vocabulary" override of the persisted default, distinct
            # from the parameter being absent
            return dict(parse_qsl(urlsplit(self.path).query,
                                  keep_blank_values=True))

        def _transcribe(self):
            """One-shot: body = raw f32 LE PCM, a WAV blob, or a FLAC blob
            (magic-sniffed, like the CLI's extension dispatch)."""
            q = self._query()
            body = self._body()
            if body[:4] == b"RIFF":
                from ..audio.io import read_wav
                from ..audio.resample import resample
                audio, rate = read_wav(body)
                audio = resample(audio, rate)
            elif body[:4] == b"fLaC":
                from ..audio.flac import read_flac
                from ..audio.resample import resample
                audio, rate = read_flac(body)
                audio = resample(audio, rate)
            else:
                rate = int(q.get("sample_rate", 16000))
                from ..audio.resample import resample
                audio = np.frombuffer(body, "<f4").astype(np.float32)
                audio = resample(audio, rate)
            # decode strategy via query params (?beam_size=5&...), plus
            # task=translate and word_timestamps=1 — the engine options
            # the CLI exposes (cli.py transcribe flags) are reachable
            # one-shot over HTTP too. Defaults come from the persisted
            # AppConfig (like sessions), query params override, and an
            # explicit DecodeOptions is ALWAYS passed: opts=None would
            # let a BatchedEngine fall back to its baked-at-startup
            # strategy, making ?task=transcribe unable to override a
            # translate-configured server.
            app = state.config_manager.config
            beam = int(q.get("beam_size", app.beam_size or 1))
            best = int(q.get("best_of", app.best_of or 1))
            temp = float(q.get("temperature", app.temperature or 0.0))
            task = q.get("task", getattr(app, "task", None)
                         or "transcribe")
            if task not in ("transcribe", "translate"):
                return self._error(
                    f"unknown task {task!r}; have transcribe, translate")
            fmt = q.get("format", "json")
            if fmt != "json":
                # reject unknown formats BEFORE burning a decode
                from ..utils.writers import WRITERS
                if fmt not in WRITERS:
                    return self._error(
                        f"unknown format {fmt!r}; have {sorted(WRITERS)}")
            words = q.get("word_timestamps", "") in ("1", "true", "yes")
            from ..decode.rules import DecodeOptions
            opts = DecodeOptions(
                beam_size=beam if beam > 1 else None,
                best_of=max(best, 1), temperature=temp,
                task=task, word_timestamps=words)
            # persisted language / custom vocabulary apply to every
            # transcription unless the request overrides them — the
            # reference threads config.language and custom_vocabulary
            # into every call (whisper.rs:91-109)
            lang = q.get("language") or app.language
            with state.borrow_engine() as engine:
                result = engine.transcribe(
                    audio,
                    language=None if lang in (None, "auto") else lang,
                    vocabulary=q.get("vocabulary",
                                     app.custom_vocabulary or None),
                    context=q.get("context"),
                    opts=opts)
            if fmt != "json":
                # subtitle/plain output straight from the serving layer
                # (?format=srt|vtt|txt|tsv, validated above), same
                # writers as the CLI's --output-format
                import io
                from ..utils.writers import WRITERS
                buf = io.StringIO()
                WRITERS[fmt](result, buf)
                body = buf.getvalue().encode("utf-8")
                self.send_response(200)
                ctype = {"srt": "application/x-subrip",
                         "vtt": "text/vtt"}.get(fmt, "text/plain")
                self.send_header("Content-Type",
                                 f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            return self._json({
                "text": result.text,
                "language": result.language,
                "segments": [dataclasses.asdict(s) for s in result.segments],
            })

        def _create_session(self):
            body = self._body()
            opts = json.loads(body) if body else {}
            app = state.config_manager.config
            # decode strategy: per-session override, else the server
            # config's defaults (strategy selection analog, whisper.rs:88).
            # Each strategy field resolves the same way: an explicit
            # per-session value wins — INCLUDING explicit neutral values
            # (beam_size=1, task="transcribe"), which must override a
            # beam/translate-configured engine back to greedy/transcribe;
            # otherwise a non-default app value becomes the session's
            # explicit value; otherwise None = inherit the engine's
            # configured strategy.
            def strategy(key, app_value, neutral):
                v = opts.get(key)
                if v is None and app_value is not None \
                        and app_value != neutral:
                    v = app_value
                return v

            beam = strategy("beam_size", app.beam_size, 1)
            best = strategy("best_of", app.best_of, 1)
            temp = strategy("temperature", app.temperature, 0.0)
            task = strategy("task", getattr(app, "task", None),
                            "transcribe")
            if task is not None and task not in ("transcribe",
                                                 "translate"):
                return self._error(
                    f"unknown task {task!r}; have transcribe, translate")
            # persisted config fills the per-session defaults the same
            # way the reference applies AppConfig to every recording
            # (language/vocabulary whisper.rs:91-109; duration cap
            # config.rs:36-38 / state.rs:361,565)
            lang = opts.get("language") or app.language
            cfg = SessionConfig(
                language=None if lang in (None, "auto") else lang,
                vocabulary=opts.get("vocabulary",
                                    app.custom_vocabulary or None),
                sample_rate=int(opts.get("sample_rate", 16000)),
                max_duration_s=int(opts.get(
                    "max_duration_s", app.max_recording_duration or 60)),
                beam_size=int(beam) if beam is not None else None,
                best_of=int(best) if best is not None else None,
                temperature=float(temp) if temp is not None else None,
                task=task)
            sid = state.create_session(cfg)
            return self._json({"session": sid})

        def _session_verb(self, sid: str, verb: str):
            s = state.sessions.get(sid)
            if s is None:
                return self._error(f"no session {sid}", 404)
            if verb == "start":
                return self._json({"started": s.start(),
                                   "state": s.state.value})
            if verb == "stop":
                text = s.stop(wait=True)
                return self._json({"transcript": text,
                                   "state": s.state.value})
            if verb == "toggle":
                return self._json({"recording": s.toggle(),
                                   "state": s.state.value})
            if verb == "cancel":
                s.cancel()
                return self._json({"state": s.state.value})
            if verb in ("press", "release"):
                # hotkey analog (native_shortcut.rs:356-396): in
                # push_to_talk mode press=start / release=stop; in toggle
                # mode press=toggle / release=no-op
                ptt = state.config_manager.config.push_to_talk
                if verb == "press":
                    if ptt:
                        return self._json({"started": s.start(),
                                           "state": s.state.value})
                    return self._json({"recording": s.toggle(),
                                       "state": s.state.value})
                if ptt:
                    s.stop(wait=False)
                return self._json({"state": s.state.value})
            if verb == "audio":
                frames = np.frombuffer(self._body(), "<f4")
                s.push_audio(frames)
                if s.over_duration_cap():     # hard cap (state.rs:622-631)
                    s.stop(wait=False)
                return self._json({"buffered": True,
                                   "state": s.state.value})
            return self._error(f"unknown verb {verb}", 404)

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8777,
          config_manager: Optional[ConfigManager] = None,
          background: bool = False,
          engine_factory=None,
          rss_watermark_mb: float = 0.0) -> ThreadingHTTPServer:
    state = ServerState(engine, config_manager, engine_factory=engine_factory)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.state = state  # for tests
    if rss_watermark_mb > 0:
        # self-defense against host-RSS growth: past the watermark this
        # backend flips to draining and stays there — the router (or operator) restarts it once its
        # sessions finish. The flag is the signal; nothing is killed
        # from inside (in-flight work must complete first).
        state.rss_watermark_mb = float(rss_watermark_mb)

        def _watch():
            while True:
                if not state.draining and rss_mb() > state.rss_watermark_mb:
                    log.warning(
                        "RSS %.0f MB over watermark %.0f MB: draining",
                        rss_mb(), state.rss_watermark_mb)
                    state.draining = True
                time.sleep(5.0)

        threading.Thread(target=_watch, daemon=True,
                         name="rss-watermark").start()
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    else:
        # graceful drain on SIGTERM/SIGINT (the production analog of
        # the reference's window-close handling, lib.rs:98-113): stop
        # accepting, then close the engine — a BatchedEngine's close()
        # DRAINS its queue, so already-submitted windows still deliver
        import signal

        def _stop(signum, frame):
            log.info("signal %d: shutting down", signum)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _stop)
            except ValueError:     # not the main thread: skip
                pass
        log.info("serving on %s:%d", host, port)
        try:
            httpd.serve_forever()
        finally:
            # state.engine, not the closure arg: a hot-swap may have
            # replaced the startup engine; retired engines still pinned
            # by sessions are closed here too
            with state._lock:
                engines = [state.engine] + state._retired
                state._retired = []
            state._close_engines(engines)
    return httpd
