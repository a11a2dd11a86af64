"""The port's fan-out router (``nobs_whisper_torch/serve/router.py``) on
the CPU: ``tests/test_router.py``'s checklists against two live port
servers (tiny checkpoint, ``device="cpu"``) and the rolling-restart
machinery on the reference's fake managed backend; one test for each of
the three faults repaired in the port's copy; and the ``route`` verb in a
subprocess over two ``serve --device cpu`` backends, stopped by SIGINT.
"""

import gc
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from tests.test_router import FAKE_BACKEND, _free_port, _http_ok, _wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Two port backend servers on one tiny CPU engine, and the router."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.router import serve_router
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint

    os.environ["NOBS_WHISPER_TPU_HOME"] = str(tmp_path_factory.mktemp("home"))
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    engine = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    backends, httpds = [], []
    for _ in range(2):
        port = _free_port()
        httpds.append(serve(engine, port=port, background=True))
        backends.append(f"http://127.0.0.1:{port}")
    rport = _free_port()
    router = serve_router(backends, port=rport, background=True)
    yield f"http://127.0.0.1:{rport}", router, backends, httpds, engine
    router.shutdown()
    for h in httpds:
        h.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _post(base, path, data=b""):
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _status(base, path, data=b""):
    try:
        return 200, _post(base, path, data)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_aggregates_all_backends(cluster):
    base, _, backends, _, _ = cluster
    h = _get(base, "/health")
    assert set(h["backends"]) == set(backends)
    assert all(v["ok"] and v["loaded"] for v in h["backends"].values())


def test_backends_listing(cluster):
    base, _, backends, _, _ = cluster
    listing = _get(base, "/backends")
    assert {b["url"] for b in listing} == set(backends)
    assert all(b["healthy"] and not b["managed"] for b in listing)


def test_session_affinity(cluster):
    """Creation balances (least-loaded); verbs land on the owning backend;
    DELETE releases the slot."""
    base, router, backends, _, _ = cluster
    sids = [_post(base, "/sessions", b"{}")["session"] for _ in range(4)]
    owners = [router.state.affinity[s].base_url for s in sids]
    assert sorted(owners.count(b) for b in backends) == [2, 2]
    for sid in sids:
        assert _post(base, f"/sessions/{sid}/start")["state"] == "recording"
        assert _post(base, f"/sessions/{sid}/cancel")["state"] == "idle"
    req = urllib.request.Request(base + f"/sessions/{sids[0]}",
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read())["deleted"]
    assert sids[0] not in router.state.affinity
    for sid in sids[1:]:
        urllib.request.urlopen(urllib.request.Request(
            base + f"/sessions/{sid}", method="DELETE"), timeout=30).read()


def test_unknown_session_404(cluster):
    base = cluster[0]
    code, body = _status(base, "/sessions/nope/start")
    assert code == 404 and "no session" in body["error"]


def test_transcribe_round_robins_with_beam(cluster):
    """Two one-shots round-robin over both backends with the same result
    (same weights); a ``?beam_size=3`` one-shot through the router answers
    200 with the engine's beam result."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    base, router, _, _, engine = cluster
    audio = (0.1 * np.sin(np.linspace(0, 300, 8000))).astype("<f4")
    rr0 = router.state._rr
    r1 = _post(base, "/transcribe?language=en", audio.tobytes())
    r2 = _post(base, "/transcribe?language=en", audio.tobytes())
    assert router.state._rr == rr0 + 2
    assert r1["text"] == r2["text"]
    code, r3 = _status(base, "/transcribe?language=en&beam_size=3",
                       audio.tobytes())
    # the server prompts with its configured vocabulary
    vocab = _get(base, "/config")["custom_vocabulary"] or None
    direct = engine.transcribe(audio, language="en", vocabulary=vocab,
                               opts=DecodeOptions(beam_size=3))
    assert code == 200
    assert [s["tokens"] for s in r3["segments"]] == \
        [s.tokens for s in direct.segments]


def test_relay_preserves_content_type(cluster):
    base = cluster[0]
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        assert "text/html" in r.headers.get("Content-Type", "")
        assert b"<html" in r.read()[:200].lower()
    audio = (np.random.RandomState(31).randn(16000) * 0.2).astype(np.float32)
    req = urllib.request.Request(base + "/transcribe?language=en&format=srt",
                                 data=audio.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert "x-subrip" in r.headers.get("Content-Type", "")


def test_reconcile_keeps_sessions_created_during_sweep(cluster):
    """A session placed while the reconcile's /state probes are in flight
    survives the sweep."""
    base, router, _, _, _ = cluster
    state = router.state
    body = json.dumps({"language": "en", "sample_rate": 16000}).encode()
    sid = _post(base, "/sessions", body)["session"]
    orig_request = state.request
    created = {}

    def racing_request(backend, method, path, body_=None, timeout=None):
        status, data = orig_request(backend, method, path, body_)
        if method == "GET" and path == "/state" and not created:
            created["sid"] = _post(base, "/sessions", body)["session"]
        return status, data

    state.request = racing_request
    try:
        state.maybe_reconcile(force=True)
    finally:
        state.request = orig_request
    for s in (sid, created["sid"]):
        assert "started" in _post(base, f"/sessions/{s}/start")
        _post(base, f"/sessions/{s}/cancel")


def test_openai_endpoints_route_through(cluster):
    base = cluster[0]
    boundary = "xNwtRouterBoundary42"
    audio = (np.random.RandomState(7).randn(8000) * 0.2).astype("<f4")
    body = (f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="file"; '
            'filename="a.pcm"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode() \
        + audio.tobytes() + (
            f"\r\n--{boundary}\r\n"
            'Content-Disposition: form-data; name="language"\r\n\r\n'
            f"en\r\n--{boundary}--\r\n").encode()
    req = urllib.request.Request(
        base + "/v1/audio/transcriptions", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert "text" in json.loads(r.read())
    assert _get(base, "/v1/models")["object"] == "list"


def test_websocket_tunnels_to_owning_backend(cluster):
    """The session's WebSocket reaches its owning backend through the
    router's upgrade tunnel: start, one body, stop with a transcript."""
    from nobs_whisper_torch.client import Client
    base = cluster[0]
    with Client(base).session(language="en") as s:
        sock = s.websocket()
        try:
            sock.send_json({"verb": "start"})
            reply = None
            for _ in range(50):
                obj = json.loads(sock.recv()[1])
                if "reply" in obj:
                    reply = obj
                    break
            assert reply and reply["reply"] == "start" and reply["started"]
            sock.send_binary((np.random.RandomState(3).randn(8000) * 0.2)
                             .astype("<f4").tobytes())
            sock.send_json({"verb": "stop"})
            for _ in range(50):
                obj = json.loads(sock.recv()[1])
                if "reply" in obj:
                    break
            assert obj["reply"] == "stop"
            assert isinstance(obj["transcript"], str)
        finally:
            sock.close()


def test_self_draining_backend_503_places_elsewhere(cluster):
    """Repaired fault: a new session that the least-loaded backend refuses
    with 503 (it is self-draining) goes to the next placeable backend;
    the reference's copy relayed the 503."""
    base, router, backends, _, _ = cluster
    state = router.state
    first = min(state.backends, key=lambda b: b.sessions)
    other = next(b for b in state.backends if b is not first)
    _post(first.base_url, "/drain")
    try:
        code, body = _status(base, "/sessions", b"{}")
        assert code == 200
        assert state.affinity[body["session"]] is other
        # with every backend refusing, the 503 itself is relayed
        _post(other.base_url, "/drain")
        code, body = _status(base, "/sessions", b"{}")
        assert code == 503
    finally:
        for b in state.backends:
            _post(b.base_url, "/undrain")


def test_failover_and_recovery(cluster):
    """Kill one backend: one-shots fail over, it is marked down, /health
    reports it as an error. Last of the cluster tests: it stops a
    backend."""
    base, router, backends, httpds, _ = cluster
    httpds[0].shutdown()
    httpds[0].server_close()
    audio = (0.1 * np.sin(np.linspace(0, 300, 8000))).astype("<f4")
    for _ in range(3):
        assert "text" in _post(base, "/transcribe?language=en",
                               audio.tobytes())
    down = next(b for b in router.state.backends
                if b.base_url == backends[0])
    assert not down.healthy()
    h = _get(base, "/health")
    assert "error" in h["backends"][backends[0]]
    assert h["backends"][backends[1]]["ok"]


# ---- rolling restarts on the reference's fake managed backend ----------

@pytest.fixture
def fake_managed(tmp_path):
    from nobs_whisper_torch.serve.router import ManagedBackend
    script = tmp_path / "fake_backend.py"
    script.write_text(FAKE_BACKEND)
    rss_file = tmp_path / "rss.txt"
    rss_file.write_text("100.0")
    port = _free_port()
    b = ManagedBackend(f"http://127.0.0.1:{port}",
                       [sys.executable, str(script), str(port),
                        str(rss_file)],
                       log_path=str(tmp_path / "fake.log"))
    yield b, rss_file
    b.terminate(grace_s=5)


def test_managed_rolling_restart_on_rss(fake_managed):
    """RSS over the watermark: drain, SIGTERM, respawn, rejoin; a session
    created during the roll queues and lands on the new process."""
    import threading
    from nobs_whisper_torch.serve.router import serve_router
    b, rss_file = fake_managed
    rport = _free_port()
    router = serve_router([b], port=rport, background=True,
                          rss_watermark_mb=500.0, poll_interval_s=0.3,
                          drain_timeout_s=10.0, health_timeout_s=30.0)
    try:
        base = f"http://127.0.0.1:{rport}"
        assert _wait(lambda: _http_ok(b.base_url + "/health"))
        pid0 = b.proc.pid
        assert _post(base, "/sessions", b"{}")["session"].startswith("fake")
        results = {}
        rss_file.write_text("9000.0")
        assert _wait(lambda: b.draining or b.restarts > 0, timeout=15)
        t = threading.Thread(
            target=lambda: results.update(r=_post(base, "/sessions", b"{}")))
        t.start()
        rss_file.write_text("100.0")
        assert _wait(lambda: b.restarts >= 1, timeout=30)
        t.join(timeout=30)
        assert not t.is_alive()
        assert results["r"]["session"].startswith("fake")
        assert b.proc.pid != pid0
        assert _wait(lambda: not b.draining and b.healthy(), timeout=30)
        listing = _get(base, "/backends")[0]
        assert listing["managed"] and listing["restarts"] >= 1
    finally:
        router.state.manager.stop()
        router.shutdown()


def test_managed_restart_on_backend_self_drain(fake_managed):
    from nobs_whisper_torch.serve.router import serve_router
    b, _ = fake_managed
    rport = _free_port()
    router = serve_router([b], port=rport, background=True,
                          poll_interval_s=0.3, drain_timeout_s=10.0,
                          health_timeout_s=30.0)
    try:
        assert _wait(lambda: _http_ok(b.base_url + "/health"))
        _post(b.base_url, "/drain", b"")
        assert _wait(lambda: b.restarts >= 1, timeout=30)
        listing = _get(f"http://127.0.0.1:{rport}", "/backends")[0]
        assert listing["restarts"] >= 1 and not listing["draining"]
    finally:
        router.state.manager.stop()
        router.shutdown()


def test_draining_backend_excluded_from_placement(tmp_path):
    from nobs_whisper_torch.serve.router import ManagedBackend, RouterState
    script = tmp_path / "fake_backend.py"
    script.write_text(FAKE_BACKEND)
    rss = tmp_path / "rss.txt"
    rss.write_text("100.0")
    bs = []
    for _ in range(2):
        port = _free_port()
        b = ManagedBackend(f"http://127.0.0.1:{port}",
                           [sys.executable, str(script), str(port), str(rss)])
        b.spawn()
        bs.append(b)
    try:
        for b in bs:
            assert _wait(lambda b=b: _http_ok(b.base_url + "/health"))
        state = RouterState(bs)
        bs[0].draining = True
        for _ in range(4):
            assert state.pick_least_loaded() is bs[1]
            assert state.pick_round_robin() is bs[1]
        state.add_session("s1", bs[0])
        assert state.session_backend("s1") is bs[0]
        bs[0].draining = False
        assert {state.pick_round_robin() for _ in range(4)} == set(bs)
    finally:
        for b in bs:
            b.terminate(grace_s=5)


def test_failed_roll_returns_backend_to_rotation(fake_managed, monkeypatch):
    """Repaired fault: a roll whose respawn fails leaves the backend out of
    placement only for the down cooldown; the reference's copy left it
    draining (never placeable again)."""
    from nobs_whisper_torch.serve import router as rt
    monkeypatch.setattr(rt, "DOWN_COOLDOWN_S", 0.5)
    b, _ = fake_managed
    state = rt.RouterState([b])
    mgr = rt.BackendManager(state, drain_timeout_s=2.0, health_timeout_s=5.0)
    b.spawn()
    assert _wait(lambda: _http_ok(b.base_url + "/health"))
    b.spawn_cmd = [sys.executable, "-c", "import sys; sys.exit(3)"]
    with pytest.raises(RuntimeError, match="exited rc=3"):
        mgr._roll(b)
    assert not b.draining and not state.restart_active
    assert b.restarts == 0 and not b.placeable()
    assert _wait(lambda: state.pick_least_loaded() is b, timeout=5)


def test_spawn_closes_its_log_handle(tmp_path):
    """Repaired fault: ``spawn`` closes the router's own handle on the log
    file once the child holds it; the reference's copy left each respawn's
    handle to the garbage collector (a ``ResourceWarning``: unclosed
    file). Every respawn appends to the one log."""
    from nobs_whisper_torch.serve.router import ManagedBackend
    log_path = tmp_path / "backend.log"
    b = ManagedBackend("http://127.0.0.1:9", [
        sys.executable, "-c", "print('spawned', flush=True)"],
        log_path=str(log_path))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            b.spawn()
            b.proc.wait(timeout=30)
            gc.collect()
    leaked = [w for w in caught if issubclass(w.category, ResourceWarning)
              and "backend.log" in str(w.message)]
    assert not leaked, leaked
    assert log_path.read_text().count("spawned") == 3


# ---- the route verb ------------------------------------------------------

def _children(pid):
    """PIDs whose parent is ``pid`` (Linux /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_route_verb_manages_serve_backends(tmp_path):
    """``cli route`` in a subprocess with two ``--manage`` backends, each
    ``cli serve --device cpu`` on a tiny checkpoint: /health aggregates
    both, a session and a one-shot go through, SIGINT exits 0 within its
    deadline, and neither spawned backend outlives it."""
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    model = str(tmp_path / "m.bin")
    write_tiny_checkpoint(model)
    env = dict(os.environ, NOBS_WHISPER_TPU_HOME=str(tmp_path),
               OMP_NUM_THREADS="1")
    ports = [_free_port() for _ in range(3)]
    cmd = [sys.executable, "-m", "nobs_whisper_torch.cli", "route",
           "--backends", ",".join(f"http://127.0.0.1:{p}"
                                  for p in ports[:2]),
           "--port", str(ports[2]), "--log-dir", str(tmp_path / "logs")]
    for p in ports[:2]:
        cmd += ["--manage", f"{sys.executable} -m nobs_whisper_torch.cli "
                f"serve --device cpu --model {model} --dtype float32 "
                f"--batch 1 --port {p}"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{ports[2]}"
    kids = []
    try:
        def up():
            try:
                h = _get(base, "/health")["backends"]
            except (OSError, ValueError):
                return False
            return len(h) == 2 and all(v.get("loaded") for v in h.values())
        assert _wait(up, timeout=120, interval=0.5), proc.stderr.read() \
            if proc.poll() is not None else "no healthy cluster"
        kids = _children(proc.pid)
        assert len(kids) == 2
        sid = _post(base, "/sessions", b'{"language": "en"}')["session"]
        assert _post(base, f"/sessions/{sid}/start")["state"] == "recording"
        _post(base, f"/sessions/{sid}/cancel")
        audio = (0.1 * np.sin(np.linspace(0, 300, 8000))).astype("<f4")
        assert "text" in _post(base, "/transcribe?language=en",
                               audio.tobytes())
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
        left = [k for k in kids if _alive(k)]
        for k in left:
            os.kill(k, signal.SIGKILL)
    assert not left
