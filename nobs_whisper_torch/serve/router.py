"""Serving fan-out: an HTTP front end over N backend servers (port of the
JAX package's ``serve/router.py``, a copy: pure stdlib, no model code).

Each backend is one backend process (one card) running the full
``serve.server`` API (``python -m nobs_whisper_torch.cli serve``); this
router spreads sessions and one-shot transcriptions over them.

Semantics:
- `POST /sessions` picks the healthy backend with the fewest live
  sessions (least-loaded); the session id is returned verbatim and all
  subsequent `/sessions/<sid>/...` verbs — including the SSE event
  stream — are proxied to the owning backend (session affinity: session
  state is host-local, exactly like the reference's in-process AppState,
  src-tauri/src/state.rs:171).
- `POST /transcribe` round-robins over healthy backends.
- `GET /health|/state|/stats` aggregate all backends.
- `GET/POST /config` and model verbs broadcast (every host keeps its own
  disk registry, mirroring the reference's per-machine models dir,
  src-tauri/src/config.rs:100-106).
- A backend that fails a request is marked down and retried after a
  cooldown; in-flight work fails over to the next healthy backend
  (per-chunk error isolation at cluster scope, state.rs:157-159 analog).

Pure stdlib, same as serve.server.

Three faults of the reference's copy are repaired here: a roll that fails
puts the backend back in rotation after the down cooldown instead of
leaving it draining forever (``BackendManager._roll``); ``spawn`` closes
its handle on the log file once the child holds it; a new session that a
self-draining backend refuses (503) goes to the next placeable backend
instead of relaying the 503 (``_create_session``). In the foreground,
SIGINT and SIGTERM stop the router cleanly, as ``serve`` stops, and the
backends it spawned are terminated.
"""

from __future__ import annotations

import json
import logging
import subprocess
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

DOWN_COOLDOWN_S = 5.0
REQUEST_TIMEOUT_S = 600.0   # transcription of a 600 s cap recording
RECONCILE_INTERVAL_S = 60.0
WAIT_PLACEABLE_S = 570.0    # max queue time through a rolling restart
                            # (just under the client default timeout)


class Backend:
    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        self.down_until = 0.0
        self.sessions = 0          # live sessions routed here; guarded by
                                   # RouterState._lock (a single lock keeps
                                   # affinity and the counters consistent)
        # rolling-restart state: a draining backend is excluded from NEW
        # placement but keeps relaying its existing sessions (affinity
        # holds until the drain completes); restarts counts completed
        # rolls, rss_mb mirrors the backend's last-seen /stats gauge
        self.draining = False
        self.restarts = 0
        self.rss_mb = 0.0

    def healthy(self) -> bool:
        return time.monotonic() >= self.down_until

    def placeable(self) -> bool:
        return self.healthy() and not self.draining

    def mark_down(self) -> None:
        self.down_until = time.monotonic() + DOWN_COOLDOWN_S
        log.warning("backend %s marked down for %.0fs", self.base_url,
                    DOWN_COOLDOWN_S)


class ManagedBackend(Backend):
    """A backend whose PROCESS this router owns: spawned at startup,
    terminated + respawned by the rolling-restart manager, which watches
    the backend's /stats RSS gauge and rolls it before the host runs out
    of memory (or on a fixed interval)."""

    def __init__(self, base_url: str, spawn_cmd: List[str],
                 env: Optional[dict] = None, log_path: Optional[str] = None):
        super().__init__(base_url)
        self.spawn_cmd = spawn_cmd
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.spawned_at = 0.0

    def spawn(self) -> None:
        if self.log_path:
            # the child holds its own copy of the descriptor: close ours,
            # or every respawn leaves one more handle open
            with open(self.log_path, "ab", buffering=0) as logf:
                self.proc = subprocess.Popen(
                    self.spawn_cmd, env=self.env, stdout=logf, stderr=logf,
                    stdin=subprocess.DEVNULL)
        else:
            self.proc = subprocess.Popen(
                self.spawn_cmd, env=self.env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL)
        self.spawned_at = time.monotonic()
        log.info("spawned backend %s (pid %d)", self.base_url,
                 self.proc.pid)

    def terminate(self, grace_s: float = 60.0) -> None:
        """SIGTERM (serve drains its engine on it), SIGKILL after
        grace. Never kills by pattern — the exact child PID only."""
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            log.warning("backend %s pid %d ignored SIGTERM; killing",
                        self.base_url, self.proc.pid)
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.proc = None


class RouterState:
    def __init__(self, backends: List):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.backends = [b if isinstance(b, Backend) else Backend(b)
                         for b in backends]
        self.affinity: Dict[str, Backend] = {}   # session id -> backend
        self._rr = 0
        self._lock = threading.Lock()
        self._placeable_cond = threading.Condition(self._lock)
        self._last_reconcile = time.monotonic()
        self._reconciling = False
        self.restart_active = False   # one roll at a time, cluster-wide
        self.manager: Optional["BackendManager"] = None

    # ---- selection ----------------------------------------------------
    def healthy_backends(self) -> List[Backend]:
        return [b for b in self.backends if b.healthy()]

    def pick_least_loaded(self, exclude=()) -> Optional[Backend]:
        self.maybe_reconcile()
        with self._lock:
            up = [b for b in self.backends
                  if b.placeable() and b not in exclude]
            return min(up, key=lambda b: b.sessions) if up else None

    def pick_round_robin(self) -> Optional[Backend]:
        with self._lock:
            up = [b for b in self.backends if b.placeable()]
            if not up:
                return None
            b = up[self._rr % len(up)]
            self._rr += 1
            return b

    def notify_placeable(self) -> None:
        with self._placeable_cond:
            self._placeable_cond.notify_all()

    def wait_placeable(self, timeout: float) -> bool:
        """Block until some backend is placeable. Only waits while a
        rolling restart / drain is the reason nothing is placeable —
        with everything genuinely down (unmanaged outage) it returns
        False immediately, preserving the fast-fail behavior.

        This is what makes a single-backend rolling restart lossless:
        during the window between SIGTERM and the respawn's first
        healthy /health, new-session and one-shot requests queue here
        instead of 502ing (zero failed requests through a restart)."""
        deadline = time.monotonic() + timeout
        with self._placeable_cond:
            while True:
                if any(b.placeable() for b in self.backends):
                    return True
                rolling = self.restart_active or any(
                    b.draining for b in self.backends)
                if not rolling:
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._placeable_cond.wait(timeout=min(remaining, 1.0))

    # ---- session bookkeeping (all under _lock) -------------------------
    def session_backend(self, sid: str) -> Optional[Backend]:
        with self._lock:
            return self.affinity.get(sid)

    def add_session(self, sid: str, backend: Backend) -> None:
        with self._lock:
            self.affinity[sid] = backend
            backend.sessions += 1

    def drop_session(self, sid: str) -> Optional[Backend]:
        with self._lock:
            b = self.affinity.pop(sid, None)
            if b is not None:
                b.sessions = max(0, b.sessions - 1)
            return b

    def maybe_reconcile(self, force: bool = False) -> None:
        """Reap affinity entries whose session no longer exists on its
        backend. A client that vanishes without DELETE would otherwise
        leak its load-count slot forever and skew least-loaded placement.

        Triggered at most every RECONCILE_INTERVAL_S and runs the HTTP
        sweep in a daemon thread so the request path (pick_least_loaded)
        never blocks on up to 10 s/backend of /state probes.
        ``force=True`` runs synchronously (tests/shutdown)."""
        now = time.monotonic()
        with self._lock:
            if (not force
                    and (now - self._last_reconcile < RECONCILE_INTERVAL_S
                         or self._reconciling)):
                return
            self._last_reconcile = now
            self._reconciling = True
        if force:
            self._reconcile_sweep()
        else:
            threading.Thread(target=self._reconcile_sweep,
                             daemon=True).start()

    def _reconcile_sweep(self) -> None:
        try:
            with self._lock:
                backends = [b for b in self.backends if b.healthy()]
                # sessions created while the sweep's /state probes are in
                # flight are NOT in the probe results; only entries that
                # predate the sweep may be reaped, or a freshly-placed
                # session would be orphaned at the router
                pre = set(self.affinity)
            live: Dict[Backend, set] = {}
            for b in backends:
                try:
                    _, data = self.request(b, "GET", "/state", timeout=10)
                    live[b] = set(json.loads(data))
                except Exception:
                    pass   # unreachable: keep its entries (nothing known)
            with self._lock:
                for sid, b in list(self.affinity.items()):
                    if sid in pre and b in live and sid not in live[b]:
                        del self.affinity[sid]
                for b, sids in live.items():
                    # truth from the backend, plus sessions routed there
                    # after the snapshot (invisible to the probe)
                    placed_after = sum(
                        1 for sid, bb in self.affinity.items()
                        if bb is b and sid not in pre)
                    b.sessions = len(sids) + placed_after
        finally:
            with self._lock:
                self._reconciling = False

    # ---- plain HTTP to a backend ---------------------------------------
    def request(self, backend: Backend, method: str, path: str,
                body: Optional[bytes] = None,
                timeout: float = REQUEST_TIMEOUT_S):
        """Returns (status, body bytes). Marks the backend down on
        connection-level failure and re-raises."""
        status, data, _ = self.request_full(backend, method, path, body,
                                            timeout)
        return status, data

    def request_full(self, backend: Backend, method: str, path: str,
                     body: Optional[bytes] = None,
                     timeout: float = REQUEST_TIMEOUT_S,
                     headers: Optional[dict] = None):
        """Like request() but also returns the response Content-Type, so
        relays can forward non-JSON bodies (the web client's HTML, vtt/srt
        transcripts) untouched. `headers` forwards request headers the
        backend needs to parse the body (the OpenAI endpoints' multipart
        boundary rides Content-Type)."""
        req = urllib.request.Request(
            backend.base_url + path, data=body, method=method,
            headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return (resp.status, resp.read(),
                        resp.headers.get("Content-Type",
                                         "application/json"))
        except urllib.error.HTTPError as e:
            # an HTTP-level error is a healthy backend answering
            return e.code, e.read(), e.headers.get("Content-Type",
                                                   "application/json")
        except (urllib.error.URLError, OSError, TimeoutError):
            backend.mark_down()
            raise


class BackendManager:
    """Rolling-restart orchestrator for ManagedBackends.

    Watches each managed backend's /stats host gauges and rolls it —
    drain, wait for its sessions to finish, SIGTERM, respawn, wait
    healthy, rejoin — when any trigger fires:
      - the backend reports itself draining (its own --rss-watermark-mb
        monitor tripped), or
      - its RSS exceeds this manager's rss_watermark_mb, or
      - restart_interval_s elapsed since its spawn (time-based rolling,
        the deterministic trigger for CI).
    One roll at a time cluster-wide; while the only backend is mid-roll
    the request path queues on RouterState.wait_placeable instead of
    failing. A roll that fails puts the backend back in rotation after
    the down cooldown (and the next poll rolls it again if its process
    died); it never stays draining.
    """

    def __init__(self, state: RouterState,
                 rss_watermark_mb: float = 0.0,
                 restart_interval_s: float = 0.0,
                 drain_timeout_s: float = 180.0,
                 health_timeout_s: float = 900.0,
                 poll_interval_s: float = 5.0):
        self.state = state
        self.rss_watermark_mb = rss_watermark_mb
        self.restart_interval_s = restart_interval_s
        self.drain_timeout_s = drain_timeout_s
        self.health_timeout_s = health_timeout_s
        self.poll_interval_s = poll_interval_s
        self.rolls_failed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def managed(self) -> List[ManagedBackend]:
        return [b for b in self.state.backends
                if isinstance(b, ManagedBackend)]

    def start(self) -> None:
        for b in self.managed:
            if b.proc is None:
                b.spawn()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="backend-manager")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for b in self.managed:
            b.terminate()

    # ---- internals -----------------------------------------------------
    def _stats_host(self, b: Backend) -> dict:
        # direct urllib, NOT state.request: a failed background gauge
        # poll (e.g. a fresh spawn that hasn't bound its socket yet)
        # must not mark the backend down and break live placement
        try:
            with urllib.request.urlopen(b.base_url + "/stats",
                                        timeout=5) as resp:
                return json.loads(resp.read()).get("host", {})
        except Exception:
            return {}

    def _should_roll(self, b: ManagedBackend) -> Optional[str]:
        if b.proc is not None and b.proc.poll() is not None:
            return f"process exited (rc={b.proc.returncode})"
        host = self._stats_host(b)
        b.rss_mb = float(host.get("rss_mb", b.rss_mb) or 0.0)
        if host.get("draining"):
            return "backend self-draining (its RSS watermark fired)"
        if self.rss_watermark_mb > 0 and b.rss_mb > self.rss_watermark_mb:
            return (f"rss {b.rss_mb:.0f} MB > watermark "
                    f"{self.rss_watermark_mb:.0f} MB")
        if (self.restart_interval_s > 0
                and time.monotonic() - b.spawned_at
                > self.restart_interval_s):
            return f"interval {self.restart_interval_s:.0f}s elapsed"
        return None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            for b in self.managed:
                reason = self._should_roll(b)
                if reason is None:
                    continue
                log.info("rolling %s: %s", b.base_url, reason)
                try:
                    self._roll(b)
                except Exception:
                    self.rolls_failed += 1
                    log.exception("roll of %s failed", b.base_url)
                break   # at most one roll per poll cycle

    def _roll(self, b: ManagedBackend) -> None:
        with self.state._lock:
            self.state.restart_active = True
        b.draining = True
        crashed = b.proc is not None and b.proc.poll() is not None
        rolled = False
        try:
            if not crashed:
                try:
                    self.state.request(b, "POST", "/drain", b"",
                                       timeout=10)
                except Exception:
                    pass   # unreachable: proceed to restart regardless
                # wait for the backend's live sessions to finish (new
                # ones are routed elsewhere / queued); count from the
                # backend itself, falling back to router affinity
                deadline = time.monotonic() + self.drain_timeout_s
                while time.monotonic() < deadline:
                    try:
                        _, data = self.state.request(b, "GET", "/state",
                                                     timeout=5)
                        n = len(json.loads(data))
                    except Exception:
                        n = b.sessions
                    if n == 0:
                        break
                    time.sleep(0.5)
                else:
                    log.warning("drain of %s timed out with sessions "
                                "live; restarting anyway", b.base_url)
            # out of rotation for the whole down window
            b.down_until = time.monotonic() + 10 * self.health_timeout_s
            b.terminate()
            b.spawn()
            deadline = time.monotonic() + self.health_timeout_s
            while time.monotonic() < deadline:
                if b.proc.poll() is not None:
                    raise RuntimeError(
                        f"respawned backend exited rc={b.proc.returncode}")
                try:
                    req = urllib.request.Request(b.base_url + "/health")
                    with urllib.request.urlopen(req, timeout=5) as resp:
                        if resp.status == 200:
                            break
                except Exception:
                    pass
                time.sleep(1.0)
            else:
                raise RuntimeError("respawned backend never got healthy")
            b.down_until = 0.0
            b.draining = False
            b.restarts += 1
            rolled = True
            log.info("backend %s rejoined (restart #%d)", b.base_url,
                     b.restarts)
        finally:
            if not rolled:
                # failed roll: back in rotation once the down cooldown
                # ends, never left draining (out of placement) for good
                b.draining = False
                b.mark_down()
            with self.state._lock:
                self.state.restart_active = False
            self.state.notify_placeable()


def make_handler(state: RouterState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("router: " + fmt, *args)

        def _json(self, obj, code=200):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _error(self, msg, code=502):
            self._json({"error": msg}, code)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(n) if n else b""

        def _relay(self, backend: Backend, method: str,
                   body: Optional[bytes] = None):
            try:
                status, data, ctype = state.request_full(
                    backend, method, self.path, body)
            except Exception as e:
                return self._error(f"backend {backend.base_url}: {e}")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _session_backend(self, sid: str) -> Optional[Backend]:
            b = state.session_backend(sid)
            if b is None:
                self._error(f"no session {sid}", 404)
            return b

        # ---- GET -------------------------------------------------------
        def do_GET(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if parts == ["health"]:
                return self._aggregate("GET", "/health", key="backends")
            if parts in (["state"], ["stats"]):
                return self._aggregate("GET", "/" + parts[0],
                                       key="backends")
            if parts == ["backends"]:
                return self._json([{
                    "url": b.base_url, "healthy": b.healthy(),
                    "sessions": b.sessions, "draining": b.draining,
                    "restarts": b.restarts,
                    "rss_mb": round(b.rss_mb, 1),
                    "managed": isinstance(b, ManagedBackend),
                } for b in state.backends])
            if len(parts) == 3 and parts[0] == "sessions" \
                    and parts[2] == "events":
                b = self._session_backend(parts[1])
                if b:
                    return self._proxy_sse(b)
                return
            if len(parts) == 3 and parts[0] == "sessions" \
                    and parts[2] == "ws":
                b = self._session_backend(parts[1])
                if b:
                    return self._tunnel_ws(b)
                return
            # config / models / download progress: first healthy backend
            b = state.pick_round_robin()
            if b is None:
                return self._error("no healthy backends")
            return self._relay(b, "GET")

        def _tunnel_ws(self, backend: Backend):
            """Relay a WebSocket upgrade to the session's OWNING backend
            and then pump raw bytes both ways — affinity must hold for
            the full-duplex channel exactly as it does for SSE (the
            urllib relays strip Upgrade headers and pick round-robin,
            which can neither upgrade nor reach the right host)."""
            import socket as socketmod
            from urllib.parse import urlsplit

            u = urlsplit(backend.base_url)
            try:
                upstream = socketmod.create_connection(
                    (u.hostname, u.port or 80), timeout=30)
            except OSError as e:
                return self._error(f"backend {backend.base_url}: {e}",
                                   502)
            try:
                # forward the original request line + headers verbatim
                # (Sec-WebSocket-Key and friends included); rewrite Host
                head = [f"GET {self.path} HTTP/1.1",
                        f"Host: {u.netloc}"]
                for k, v in self.headers.items():
                    if k.lower() != "host":
                        head.append(f"{k}: {v}")
                upstream.sendall(("\r\n".join(head) + "\r\n\r\n")
                                 .encode("latin-1"))
                # read the backend's response head and forward verbatim
                # (101 or an error — either way the client sees exactly
                # what the backend said)
                resp = b""
                while b"\r\n\r\n" not in resp:
                    chunk = upstream.recv(65536)
                    if not chunk:
                        return self._error("backend closed during "
                                           "websocket handshake", 502)
                    resp += chunk
                self.connection.sendall(resp)
                if not resp.startswith(b"HTTP/1.1 101"):
                    return
                # hijacked: pump bytes until either side closes. One
                # direction inline (this handler thread), one in a
                # helper; both sockets shut down when either ends.
                client = self.connection
                self.close_connection = True

                def pump(src, dst):
                    try:
                        while True:
                            data = src.recv(65536)
                            if not data:
                                break
                            dst.sendall(data)
                    except OSError:
                        pass
                    finally:
                        for s in (src, dst):
                            try:
                                s.shutdown(socketmod.SHUT_RDWR)
                            except OSError:
                                pass

                t = threading.Thread(target=pump,
                                     args=(upstream, client),
                                     daemon=True)
                t.start()
                pump(client, upstream)
                t.join(timeout=10)
            finally:
                try:
                    upstream.close()
                except OSError:
                    pass

        def _aggregate(self, method: str, path: str, key: str):
            out = {}
            for b in state.backends:
                if not b.healthy():
                    out[b.base_url] = {"error": "down"}
                    continue
                try:
                    _, data = state.request(b, method, path, timeout=10)
                    out[b.base_url] = json.loads(data)
                except Exception as e:
                    out[b.base_url] = {"error": str(e)}
            self._json({key: out})

        def _proxy_sse(self, backend: Backend):
            """Stream the backend's SSE body through unbuffered."""
            import http.client
            from urllib.parse import urlsplit
            u = urlsplit(backend.base_url)
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=REQUEST_TIMEOUT_S)
            try:
                conn.request("GET", self.path)
                resp = conn.getresponse()
                self.send_response(resp.status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                # stream until backend closes; length unknown
                self.send_header("Connection", "close")
                self.end_headers()
                while True:
                    chunk = resp.read1(8192)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            except OSError as e:
                log.warning("SSE proxy to %s failed: %s",
                            backend.base_url, e)
            finally:
                conn.close()

        # ---- POST ------------------------------------------------------
        def do_POST(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            body = self._body()
            if parts == ["sessions"]:
                return self._create_session(body)
            if len(parts) >= 2 and parts[0] == "sessions":
                b = self._session_backend(parts[1])
                if b:
                    self._relay(b, "POST", body)
                return
            if parts == ["transcribe"]:
                return self._transcribe(body)
            if len(parts) == 3 and parts[:2] == ["v1", "audio"]:
                # OpenAI-compatible one-shots: stateless like
                # /transcribe, same round-robin + failover; the
                # multipart boundary lives in Content-Type, forward it
                return self._transcribe(body, headers={
                    "Content-Type":
                        self.headers.get("Content-Type", "")})
            if parts == ["config"] or (
                    len(parts) == 3 and parts[0] == "models"):
                # broadcast: config + model downloads apply on every host
                results = {}
                for b in state.backends:
                    if not b.healthy():
                        results[b.base_url] = {"error": "down"}
                        continue
                    try:
                        _, data = state.request(b, "POST", self.path, body,
                                                timeout=30)
                        results[b.base_url] = json.loads(data)
                    except Exception as e:
                        results[b.base_url] = {"error": str(e)}
                return self._json({"backends": results})
            self._error("not found", 404)

        def _create_session(self, body: bytes):
            """Least-loaded placement. A backend that refuses with 503
            (self-draining: its RSS watermark fired) is skipped for this
            request and the next placeable backend is tried; the 503 is
            relayed only when every placeable backend refused."""
            b = state.pick_least_loaded()
            if b is None and state.wait_placeable(WAIT_PLACEABLE_S):
                # a rolling restart is mid-flight: queue instead of 502
                b = state.pick_least_loaded()
            if b is None:
                return self._error("no healthy backends")
            tried = set()
            while True:
                tried.add(b)
                try:
                    status, data = state.request(b, "POST", "/sessions",
                                                 body, timeout=30)
                except Exception as e:
                    return self._error(f"backend {b.base_url}: {e}")
                nxt = (state.pick_least_loaded(exclude=tried)
                       if status == 503 else None)
                if nxt is None:
                    break
                b = nxt
            if status == 200:
                sid = json.loads(data)["session"]
                state.add_session(sid, b)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _transcribe(self, body: bytes, headers: Optional[dict] = None):
            """Round-robin with failover: a connection-level failure on
            one backend retries the remaining healthy ones. When a
            rolling restart empties the pool, queue (wait_placeable)
            once and retry — tried resets because the respawned backend
            reuses its URL."""
            tried = set()
            waited = False
            while True:
                b = state.pick_round_robin()
                if b is None or b.base_url in tried:
                    if not waited and state.wait_placeable(
                            WAIT_PLACEABLE_S):
                        waited = True
                        tried.clear()
                        continue
                    return self._error("no healthy backends")
                tried.add(b.base_url)
                try:
                    status, data, ctype = state.request_full(
                        b, "POST", self.path, body, headers=headers)
                except Exception:
                    continue   # marked down; try the next one
                self.send_response(status)
                # forward the backend's content type: ?format=srt|vtt
                # responses are not JSON
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return

        def do_DELETE(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if len(parts) == 2 and parts[0] == "sessions":
                b = state.session_backend(parts[1])
                if b is None:
                    return self._error(f"no session {parts[1]}", 404)
                # relay FIRST: if the backend is unreachable the session
                # survives there, so the mapping must survive too (the
                # client can retry the DELETE); any HTTP answer — 404
                # included — means the backend resolved it, drop then.
                try:
                    status, data = state.request(b, "DELETE", self.path)
                except Exception as e:
                    return self._error(f"backend {b.base_url}: {e}")
                state.drop_session(parts[1])
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            b = state.pick_round_robin()
            if b is None:
                return self._error("no healthy backends")
            return self._relay(b, "DELETE")

    return Handler


def serve_router(backends: List, host: str = "127.0.0.1",
                 port: int = 8700,
                 background: bool = False,
                 manager: Optional[BackendManager] = None,
                 **manager_kw) -> ThreadingHTTPServer:
    """`backends` mixes plain URLs and ManagedBackend instances. When
    any backend is managed (or an explicit `manager` is passed), the
    rolling-restart manager spawns the managed processes and starts its
    watch loop; `manager_kw` (rss_watermark_mb, restart_interval_s,
    drain_timeout_s, health_timeout_s, poll_interval_s) configure it."""
    state = RouterState(backends)
    if manager is None and (manager_kw
                            or any(isinstance(b, ManagedBackend)
                                   for b in state.backends)):
        manager = BackendManager(state, **manager_kw)
    if manager is not None:
        state.manager = manager
        manager.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.state = state  # for tests
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    else:
        # SIGINT/SIGTERM stop serving, then the manager terminates the
        # backends it spawned (each drains on its SIGTERM): the process
        # exits 0 with no child left behind
        import signal

        def _stop(signum, frame):
            log.info("signal %d: shutting down", signum)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _stop)
            except ValueError:     # not the main thread: skip
                pass
        log.info("routing %d backends on %s:%d", len(backends), host, port)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            if manager is not None:
                manager.stop()
    return httpd
