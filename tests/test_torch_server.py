"""HTTP session API integration: config, models, sessions, transcribe,
SSE events — against a live server with the tiny-random engine."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch


torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores


@pytest.fixture(autouse=True)
def isolated_home(tmp_path, monkeypatch):
    monkeypatch.setenv("NOBS_WHISPER_TPU_HOME", str(tmp_path))
    yield tmp_path


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
    yield f"http://127.0.0.1:{port}", httpd
    httpd.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _post(base, path, data=b"", headers=None):
    req = urllib.request.Request(base + path, data=data, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_health(server):
    base, _ = server
    h = _get(base, "/health")
    assert h["ok"] and h["loaded"]


def test_config_roundtrip(server):
    base, _ = server
    cfg = _get(base, "/config")
    assert cfg["language"] == "auto"
    cfg["language"] = "ko"
    out = _post(base, "/config", json.dumps(cfg).encode())
    assert out["language"] == "ko"
    assert _get(base, "/config")["language"] == "ko"


def test_models_listing(server):
    base, _ = server
    models = _get(base, "/models")
    assert len(models) == 12
    assert _get(base, "/models/tiny/progress")["progress"] is None


def test_one_shot_transcribe(server):
    base, _ = server
    rng = np.random.RandomState(0)
    audio = (rng.randn(8000) * 0.2).astype(np.float32)
    out = _post(base, "/transcribe?language=en", audio.tobytes())
    assert "text" in out and out["language"] == "en"


def test_one_shot_transcribe_wav(server):
    base, _ = server
    import io
    from nobs_whisper_torch.audio.io import write_wav
    import tempfile, os
    audio = (np.random.RandomState(1).randn(8000) * 0.2).astype(np.float32)
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        name = f.name
    write_wav(name, audio)
    with open(name, "rb") as f:
        blob = f.read()
    os.unlink(name)
    out = _post(base, "/transcribe?language=en", blob)
    assert "text" in out


def test_one_shot_transcribe_flac(server):
    """FLAC bodies are magic-sniffed like WAV; same text as the identical
    raw-PCM upload (16-bit quantization tolerated by the tiny model)."""
    base, _ = server
    import io
    from nobs_whisper_torch.audio.flac import write_flac
    audio = (np.random.RandomState(2).randn(8000) * 0.2).astype(np.float32)
    buf = io.BytesIO()
    write_flac(buf, audio, 16000)
    out = _post(base, "/transcribe?language=en", buf.getvalue())
    assert "text" in out and out["language"] == "en"


def test_session_lifecycle_with_events(server):
    base, _ = server
    sid = _post(base, "/sessions", json.dumps(
        {"language": "en", "sample_rate": 16000}).encode())["session"]

    events = []

    def listen():
        req = urllib.request.Request(f"{base}/sessions/{sid}/events")
        with urllib.request.urlopen(req, timeout=120) as r:
            for line in r:
                line = line.decode().strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[6:]))
                    if events[-1].get("is_final") or \
                            events[-1]["state"] == "cancelled":
                        return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    time.sleep(0.2)

    out = _post(base, f"/sessions/{sid}/start")
    assert out["started"] and out["state"] == "recording"
    # idempotent start
    assert _post(base, f"/sessions/{sid}/start")["started"] is False

    rng = np.random.RandomState(2)
    audio = (rng.randn(16000) * 0.2).astype(np.float32)
    r = _post(base, f"/sessions/{sid}/audio", audio.tobytes())
    assert r["buffered"]

    out = _post(base, f"/sessions/{sid}/stop")
    assert out["state"] == "idle"
    assert isinstance(out["transcript"], str)

    t.join(timeout=30)
    states = [e["state"] for e in events]
    assert "recording" in states
    assert states[-1] == "done"
    assert events[-1]["is_final"]


def test_session_cancel(server):
    base, _ = server
    sid = _post(base, "/sessions", b"")["session"]
    _post(base, f"/sessions/{sid}/start")
    out = _post(base, f"/sessions/{sid}/cancel")
    assert out["state"] == "idle"


def test_press_release_hotkey_semantics(server):
    """press/release = the reference hotkey events
    (native_shortcut.rs:356-396): toggle mode presses toggle; push-to-talk
    mode maps press->start, release->stop."""
    base, httpd = server
    sid = _post(base, "/sessions", b"")["session"]

    # toggle mode (push_to_talk=False, the default)
    cm = httpd.state.config_manager
    cm.update(push_to_talk=False)
    assert _post(base, f"/sessions/{sid}/press")["recording"] is True
    assert _post(base, f"/sessions/{sid}/release")["state"] == "recording"
    assert _post(base, f"/sessions/{sid}/press")["recording"] is False
    _wait_idle(base, sid)

    # push-to-talk mode: hold to record
    cm.update(push_to_talk=True)
    assert _post(base, f"/sessions/{sid}/press")["started"] is True
    assert _post(base, f"/sessions/{sid}/press")["started"] is False  # held
    _post(base, f"/sessions/{sid}/release")
    _wait_idle(base, sid)
    cm.update(push_to_talk=False)


def _wait_idle(base, sid, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _get(base, "/state")[sid] == "idle":
            return
        time.sleep(0.05)
    raise TimeoutError(f"session {sid} never went idle")


def test_web_client_served_and_drives_full_cycle(server):
    """The built-in web client (L7 settings-SPA analog,
    src/routes/+page.svelte) is served at / and its exact call sequence —
    create session (SSE attach), toggle to record, push mic PCM, toggle
    to stop — produces a final transcript event."""
    base, _ = server
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        assert r.status == 200
        assert "text/html" in r.headers["Content-Type"]
        page = r.read().decode()
    # the page drives these endpoints; pin their presence in the markup
    for needle in ("/sessions", "/config", "/models", "EventSource",
                   "getUserMedia", "toggle"):
        assert needle in page, needle

    # the page's session flow, urllib-level
    sid = _post(base, "/sessions", json.dumps(
        {"sample_rate": 16000, "language": "en"}).encode())["session"]
    events = []

    def listen():
        req = urllib.request.Request(f"{base}/sessions/{sid}/events")
        with urllib.request.urlopen(req, timeout=120) as r:
            for line in r:
                line = line.decode().strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[6:]))
                    if events[-1].get("is_final"):
                        return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    time.sleep(0.2)
    assert _post(base, f"/sessions/{sid}/toggle")["recording"] is True
    audio = (np.random.RandomState(9).randn(16000) * 0.2).astype(np.float32)
    _post(base, f"/sessions/{sid}/audio", audio.tobytes())
    assert _post(base, f"/sessions/{sid}/toggle")["recording"] is False
    _wait_idle(base, sid, timeout=120)
    t.join(timeout=60)
    assert events and events[-1]["is_final"]
    assert isinstance(events[-1]["transcript"], str)


def test_beam_reachable_through_serving_surface(server):
    """Beam decoding is selectable from the serving layer as in the
    reference (one-shot ?beam_size= and a per-session beam_size), and it
    is served: the one-shot answers 200 with the tokens of the engine's
    own beam call on the same audio (with the configured vocabulary, as
    the server prompts), and the session's transcript is that call's
    text."""
    from nobs_whisper_torch.decode.rules import DecodeOptions

    base, httpd = server
    audio = (np.random.RandomState(7).randn(16000) * 0.2).astype(np.float32)
    vocab = _get(base, "/config")["custom_vocabulary"] or None
    direct = httpd.state.engine.transcribe(
        audio, language="en", vocabulary=vocab,
        opts=DecodeOptions(beam_size=3))

    code, body = _status_of(base, "/transcribe?language=en&beam_size=3",
                            data=audio.tobytes())
    assert code == 200
    assert [s["tokens"] for s in body["segments"]] == \
        [s.tokens for s in direct.segments]
    assert body["text"] == direct.text

    sid = _post(base, "/sessions", json.dumps(
        {"language": "en", "sample_rate": 16000,
         "beam_size": 3}).encode())["session"]
    _post(base, f"/sessions/{sid}/start")
    _post(base, f"/sessions/{sid}/audio", audio.tobytes())
    out = _post(base, f"/sessions/{sid}/stop")
    assert out == {"transcript": direct.text, "state": "idle"}


def test_translate_and_word_timestamps_reachable(server):
    """task=translate and word_timestamps are reachable from the serving
    layer, not just the CLI: translate gives the engine's own result on
    the one-shot and the session paths; word timestamps reach the engine
    and the one-shot answers 200 with the engine's own words."""
    from nobs_whisper_torch.decode.rules import DecodeOptions

    base, httpd = server
    audio = (np.random.RandomState(11).randn(16000) * 0.2).astype(np.float32)
    # the server applies the configured vocabulary to every call (the
    # port's tiny random model is not prompt-invariant)
    vocab = _get(base, "/config")["custom_vocabulary"] or None
    direct = httpd.state.engine.transcribe(
        audio, language="en", vocabulary=vocab,
        opts=DecodeOptions(task="translate"))
    one_shot = _post(base, "/transcribe?language=en&task=translate",
                     audio.tobytes())
    assert one_shot["text"] == direct.text

    code, body = _status_of(
        base, "/transcribe?language=en&task=translate&word_timestamps=1",
        data=audio.tobytes())
    direct_w = httpd.state.engine.transcribe(
        audio, language="en", vocabulary=vocab,
        opts=DecodeOptions(task="translate", word_timestamps=True))
    assert code == 200 and body["text"] == direct_w.text == direct.text
    got = [(w["word"], w["tokens"], w["start"], w["end"])
           for s in body["segments"] for w in s["words"]]
    assert got and got == [(w.word, w.tokens, w.start, w.end)
                           for s in direct_w.segments for w in s.words]

    # per-session translate routes through SessionConfig.decode_opts
    sid = _post(base, "/sessions", json.dumps(
        {"language": "en", "sample_rate": 16000,
         "task": "translate"}).encode())["session"]
    _post(base, f"/sessions/{sid}/start")
    _post(base, f"/sessions/{sid}/audio", audio.tobytes())
    out = _post(base, f"/sessions/{sid}/stop")
    assert out["transcript"] == direct.text


def test_task_override_and_validation(server):
    """A configured task=translate applies to one-shots by default, an
    explicit ?task=transcribe overrides it back, and unknown tasks are
    rejected with 400 at every surface (one-shot, session, config).

    Text equality would not show which task ran — assert on the
    DecodeOptions the engine actually receives instead."""
    base, httpd = server
    audio = (np.random.RandomState(19).randn(16000) * 0.2).astype(np.float32)
    cfg = _get(base, "/config")
    eng = httpd.state.engine
    orig = eng.transcribe
    seen = []

    def spy(a, **kw):
        seen.append(kw.get("opts"))
        return orig(a, **kw)

    eng.transcribe = spy
    try:
        cfg["task"] = "translate"
        _post(base, "/config", json.dumps(cfg).encode())

        _post(base, "/transcribe?language=en", audio.tobytes())
        assert seen[-1] is not None and seen[-1].task == "translate"
        _post(base, "/transcribe?language=en&task=transcribe",
              audio.tobytes())
        assert seen[-1] is not None and seen[-1].task == "transcribe"

        # a default session inherits the configured translate task
        sid = _post(base, "/sessions", json.dumps(
            {"language": "en", "sample_rate": 16000}).encode())["session"]
        _post(base, f"/sessions/{sid}/start")
        _post(base, f"/sessions/{sid}/audio", audio.tobytes())
        _post(base, f"/sessions/{sid}/stop")
        assert seen[-1] is not None and seen[-1].task == "translate"

        # unknown task -> 400 everywhere, before any decode runs
        n_calls = len(seen)
        for path, body in (
                ("/transcribe?task=subtitle", audio.tobytes()),
                ("/sessions", json.dumps({"task": "Transcribe"}).encode())):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, path, body)
            assert e.value.code == 400
        assert len(seen) == n_calls  # rejected without decoding
        bad = dict(cfg, task="nope")
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/config", json.dumps(bad).encode())
        assert e.value.code == 400
    finally:
        eng.transcribe = orig
        cfg["task"] = "transcribe"
        _post(base, "/config", json.dumps(cfg).encode())


def test_session_beam_opt_out(server):
    """An explicit beam_size=1 in a session must force greedy even when
    the server config defaults to beam (review finding: explicit 1 was
    collapsed to 'inherit'); omitting beam_size inherits the config."""
    base, httpd = server
    audio = (np.random.RandomState(29).randn(16000) * 0.2).astype(np.float32)
    cfg = _get(base, "/config")
    eng = httpd.state.engine
    orig = eng.transcribe
    seen = []

    def spy(a, **kw):
        seen.append(kw.get("opts"))
        return orig(a, **kw)

    eng.transcribe = spy
    try:
        cfg["beam_size"] = 3
        _post(base, "/config", json.dumps(cfg).encode())

        def run_session(body):
            sid = _post(base, "/sessions", json.dumps(body).encode())[
                "session"]
            _post(base, f"/sessions/{sid}/start")
            _post(base, f"/sessions/{sid}/audio", audio.tobytes())
            _post(base, f"/sessions/{sid}/stop")

        run_session({"language": "en", "sample_rate": 16000})
        assert seen[-1] is not None and seen[-1].beam_size == 3
        run_session({"language": "en", "sample_rate": 16000,
                     "beam_size": 1})
        assert seen[-1] is not None and seen[-1].beam_size is None
    finally:
        eng.transcribe = orig
        cfg["beam_size"] = 1
        _post(base, "/config", json.dumps(cfg).encode())


def test_opts_language_not_clobbered_by_default_kwarg(server):
    """Like task, a language pinned inside DecodeOptions survives an
    omitted language kwarg; an explicit "auto" still forces detection."""
    from nobs_whisper_torch.decode.rules import DecodeOptions

    _, httpd = server
    audio = (np.random.RandomState(23).randn(16000) * 0.2).astype(np.float32)
    via_kwarg = httpd.state.engine.transcribe(audio, language="en")
    via_opts = httpd.state.engine.transcribe(
        audio, opts=DecodeOptions(language="en"))
    assert via_opts.language == via_kwarg.language == "en"
    auto = httpd.state.engine.transcribe(
        audio, language="auto", opts=DecodeOptions(language="en"))
    assert auto.language  # detection ran (language chosen by the model)


def test_transcribe_output_formats(server):
    """?format=srt|vtt|txt|tsv returns the CLI writers' output through
    the serving surface; unknown formats 400."""
    base, _ = server
    audio = (np.random.RandomState(17).randn(16000) * 0.2).astype(np.float32)

    def raw(fmt):
        req = urllib.request.Request(
            base + f"/transcribe?language=en&format={fmt}",
            data=audio.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read().decode(), r.headers.get("Content-Type", "")

    srt, ctype = raw("srt")
    assert "-->" in srt and "x-subrip" in ctype
    vtt, ctype = raw("vtt")
    assert vtt.startswith("WEBVTT") and "text/vtt" in ctype
    txt, _ = raw("txt")
    assert isinstance(txt, str)
    tsv, _ = raw("tsv")
    assert tsv.splitlines()[0] == "start\tend\ttext"
    with pytest.raises(urllib.error.HTTPError) as e:
        raw("nope")
    assert e.value.code == 400


def test_opts_task_not_clobbered_by_default_kwarg(server):
    """engine.transcribe(opts=DecodeOptions(task='translate')) must honor
    the task carried in opts when the task kwarg is omitted (sessions and
    the batched-engine fallback pass the task only through opts)."""
    from nobs_whisper_torch.decode.rules import DecodeOptions

    _, httpd = server
    audio = (np.random.RandomState(13).randn(16000) * 0.2).astype(np.float32)
    via_kwarg = httpd.state.engine.transcribe(
        audio, language="en", task="translate")
    via_opts = httpd.state.engine.transcribe(
        audio, language="en", opts=DecodeOptions(task="translate"))
    assert via_opts.text == via_kwarg.text


def test_unknown_session_404(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/sessions/nope/start")
    assert e.value.code == 404


def test_stats_endpoint(server):
    base, _ = server
    # generate some activity first
    audio = (np.random.RandomState(5).randn(8000) * 0.2).astype(np.float32)
    _post(base, "/transcribe?language=en", audio.tobytes())
    stats = _get(base, "/stats")
    assert "stages" in stats
    assert "decode" in stats["stages"]
    assert stats["stages"]["decode"]["count"] >= 1


def test_stats_batcher_queue_wait_and_step_parts(server):
    """A batching server's /stats reports its requests' queue wait (p50,
    p95 over the recent batches' rows) and the host ms a decode step by
    part, from the batches' records."""
    import socket
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.serve.server import serve
    _, httpd = server
    # the server passes default options, which a BatchedEngine serves
    # through its batcher when they are its own
    batched = BatchedEngine(httpd.state.engine, opts=DecodeOptions(),
                            max_batch=2, max_wait_ms=5)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    srv = serve(batched, port=port, background=True)
    base = f"http://127.0.0.1:{port}"
    try:
        audio = (np.random.RandomState(6).randn(8000) * 0.2).astype(
            np.float32)
        _post(base, "/transcribe?language=en", audio.tobytes())
        b = _get(base, "/stats")["batcher"]
    finally:
        srv.shutdown()
        batched.close()
    assert 0 <= b["queue_wait_ms"]["p50"] <= b["queue_wait_ms"]["p95"]
    assert set(b["step_ms"]) == {"forward", "rules", "sync", "capture",
                                 "replayed_share"}
    assert b["step_ms"]["forward"] > 0 and b["step_ms"]["rules"] > 0
    assert b["step_ms"]["sync"] >= 0
    # the CPU runs the steps eagerly: no capture, no replay
    assert b["step_ms"]["capture"] == b["step_ms"]["replayed_share"] == 0


def test_persisted_config_applies_serverside(server):
    """max_recording_duration, language, and custom_vocabulary from the
    persisted AppConfig apply to sessions and one-shots when the request
    doesn't override them (reference semantics: config.rs:36-38 +
    whisper.rs:91-109)."""
    base, httpd = server
    cfg = _get(base, "/config")
    eng = httpd.state.engine
    orig = eng.transcribe
    seen = []

    def spy(a, **kw):
        seen.append(kw)
        return orig(a, **kw)

    eng.transcribe = spy
    try:
        cfg.update(max_recording_duration=300, language="en",
                   custom_vocabulary="tpu pallas")
        _post(base, "/config", json.dumps(cfg).encode())

        sid = _post(base, "/sessions",
                    json.dumps({"sample_rate": 16000}).encode())["session"]
        s = httpd.state.sessions[sid]
        assert s.config.max_duration_s == 300
        assert s.config.language == "en"
        assert s.config.vocabulary == "tpu pallas"

        audio = (np.random.RandomState(31).randn(8000) * 0.2).astype(
            np.float32)
        _post(base, "/transcribe", audio.tobytes())
        assert seen[-1]["language"] == "en"
        assert seen[-1]["vocabulary"] == "tpu pallas"
        # explicit request params still override
        _post(base, "/transcribe?language=auto&vocabulary=", audio.tobytes())
        assert seen[-1]["language"] is None
        assert not seen[-1]["vocabulary"]
    finally:
        eng.transcribe = orig
        cfg.update(max_recording_duration=60, language="auto",
                   custom_vocabulary="")
        _post(base, "/config", json.dumps(cfg).encode())


def test_model_download_and_delete_errors_are_http(server):
    """Unknown-model downloads/deletes surface as HTTP errors, not
    connection drops or silent daemon-thread failures; duplicates 409."""
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/models/bogus/download")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        with urllib.request.urlopen(urllib.request.Request(
                base + "/models/bogus", method="DELETE"), timeout=30):
            pass
    assert e.value.code == 404


def test_session_delete_drops_event_queues(server):
    base, httpd = server
    sid = _post(base, "/sessions",
                json.dumps({"sample_rate": 16000}).encode())["session"]
    # subscribe so the queue entry exists
    httpd.state.subscribe(sid)
    assert sid in httpd.state.event_queues
    req = urllib.request.Request(base + f"/sessions/{sid}",
                                 method="DELETE")
    urllib.request.urlopen(req, timeout=30).read()
    assert sid not in httpd.state.event_queues
    assert sid not in httpd.state.sessions


def test_config_hot_swap_live_server(tmp_path):
    """POST /config with a new selected_model rebuilds the serving engine
    through the CLI-supplied factory (the reference's live model
    hot-swap, config.rs:138-164) and the server keeps serving on the new
    engine; unrelated config changes do NOT rebuild."""
    import socket

    import torch

    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint

    p1 = str(tmp_path / "ggml-a.bin")
    p2 = str(tmp_path / "ggml-b.bin")
    write_tiny_checkpoint(p1)
    write_tiny_checkpoint(p2, seed=1)

    built = []

    def factory(model_id):
        built.append(model_id)
        return WhisperEngine.from_ggml(model_id, dtype=torch.float32, device="cpu")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(factory(p1), port=port, background=True,
                  engine_factory=factory)
    base = f"http://127.0.0.1:{port}"
    try:
        first = httpd.state.engine
        assert built == [p1]
        _post(base, "/config", json.dumps({"selected_model": p2}).encode())
        assert built == [p1, p2]
        assert httpd.state.engine is not first
        assert httpd.state.engine.model_path == p2
        # unrelated change: no rebuild (reference semantics)
        _post(base, "/config", json.dumps(
            {"selected_model": p2, "language": "ja"}).encode())
        assert built == [p1, p2]
        # the server still answers on the swapped engine
        assert _get(base, "/health")["loaded"]
    finally:
        httpd.shutdown()


# ---------------------------------------------------------------------------
# hot-swap engine lifecycle (deferred close while referenced)
# ---------------------------------------------------------------------------

class _FakeEngine:
    loaded = True
    model_path = "fake"

    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_hot_swap_defers_close_while_session_holds_engine(isolated_home):
    """A live session pins its engine snapshot across a hot-swap: the
    displaced engine is retired, not closed, until the last session
    referencing it is deleted — so in-flight work never lands on a dead
    batcher queue."""
    from nobs_whisper_torch.pipeline.session import SessionConfig
    from nobs_whisper_torch.serve.server import ServerState

    e1, e2 = _FakeEngine(), _FakeEngine()
    st = ServerState(e1, engine_factory=lambda mid: e2)
    sid = st.create_session(SessionConfig())
    st._hot_swap("other")
    assert st.engine is e2
    assert not e1.closed                  # session still holds it
    st.sessions.pop(sid)
    st.reap_retired()
    assert e1.closed


def test_hot_swap_closes_unreferenced_old_engine(isolated_home):
    from nobs_whisper_torch.serve.server import ServerState

    e1, e2 = _FakeEngine(), _FakeEngine()
    st = ServerState(e1, engine_factory=lambda mid: e2)
    st._hot_swap("other")                 # no sessions, no borrows
    assert e1.closed
    assert st._retired == []


def test_borrow_engine_pins_one_shot_across_swap(isolated_home):
    from nobs_whisper_torch.serve.server import ServerState

    e1, e2 = _FakeEngine(), _FakeEngine()
    st = ServerState(e1, engine_factory=lambda mid: e2)
    with st.borrow_engine() as eng:
        assert eng is e1
        st._hot_swap("other")
        assert not e1.closed              # pinned by the borrow
    assert e1.closed                      # released -> reaped
    assert st._borrows == {}


def test_hot_swap_mid_session_batched_engine(tmp_path):
    """End-to-end deferred-close: a session opened on a BatchedEngine
    keeps transcribing after a /config hot-swap retires that engine
    (its batcher thread must stay alive), the new engine serves new
    sessions, and deleting the old session finally closes the retired
    engine."""
    import socket

    import torch

    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint

    p1 = str(tmp_path / "ggml-a.bin")
    p2 = str(tmp_path / "ggml-b.bin")
    write_tiny_checkpoint(p1)
    write_tiny_checkpoint(p2, seed=1)

    def factory(model_id):
        eng = WhisperEngine.from_ggml(model_id, dtype=torch.float32, device="cpu")
        return BatchedEngine(eng, opts=DecodeOptions(), max_batch=2,
                             max_wait_ms=5)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(factory(p1), port=port, background=True,
                  engine_factory=factory)
    base = f"http://127.0.0.1:{port}"
    try:
        first = httpd.state.engine
        sid = _post(base, "/sessions", json.dumps(
            {"language": "en", "sample_rate": 16000}).encode())["session"]
        assert _post(base, f"/sessions/{sid}/start")["started"]
        # swap models while the session is recording
        _post(base, "/config", json.dumps({"selected_model": p2}).encode())
        assert httpd.state.engine is not first
        assert first.batcher._running          # retired, NOT closed
        # the old session still completes on its engine snapshot
        rng = np.random.RandomState(3)
        audio = (rng.randn(16000) * 0.2).astype(np.float32)
        assert _post(base, f"/sessions/{sid}/audio", audio.tobytes())[
            "buffered"]
        out = _post(base, f"/sessions/{sid}/stop")
        assert out["state"] == "idle" and isinstance(out["transcript"], str)
        # a NEW session lands on the swapped engine
        sid2 = _post(base, "/sessions", json.dumps(
            {"language": "en", "sample_rate": 16000}).encode())["session"]
        assert httpd.state.sessions[sid2].engine is httpd.state.engine
        # deleting the old session releases the retired engine
        req = urllib.request.Request(base + f"/sessions/{sid}",
                                     method="DELETE")
        urllib.request.urlopen(req, timeout=30).read()
        assert not first.batcher._running      # drained and closed
        with pytest.raises(RuntimeError, match="closed"):
            first.batcher.submit(None, [0], frames=np.zeros(
                (10, 400), np.float32))
    finally:
        httpd.shutdown()


# ---------------------------------------------------------------------------
# model-less first launch (lib.rs:26-42: preload only IF configured; the
# settings UI downloads + selects). serve boots with engine=None, serves
# management surfaces, 409s transcription, and builds the engine on first
# selection through the hot-swap factory.
# ---------------------------------------------------------------------------

def _status_of(base, path, method="POST", data=b""):
    import urllib.error
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_model_less_first_launch_download_select_transcribe(
        tmp_path, monkeypatch):
    import io
    import socket

    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve import models as model_registry
    from nobs_whisper_torch.serve.config import ConfigManager
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import (sine_audio,
                                                  write_tiny_checkpoint)

    # the "download server": any registry URL serves tiny-random GGML bytes
    blob = io.BytesIO()
    ckpt = tmp_path / "payload.bin"
    write_tiny_checkpoint(str(ckpt))
    payload = ckpt.read_bytes()

    class FakeResponse:
        headers = {"Content-Length": str(len(payload))}

        def __init__(self):
            self._buf = io.BytesIO(payload)

        def read(self, n):
            return self._buf.read(n)

    real_download = model_registry.download_model
    monkeypatch.setattr(
        model_registry, "download_model",
        lambda mid, **kw: real_download(
            mid, _opener=lambda url: FakeResponse(), **kw))

    built = []

    def factory(model_id, warmup=False):
        # the cmd_serve build path: id -> registry path -> engine
        path = model_id if model_id.endswith(".bin") \
            else str(model_registry.model_path(model_id))
        built.append(model_id)
        return WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")

    cm = ConfigManager()
    assert cm.config.selected_model is None     # truly empty first launch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(None, port=port, background=True, config_manager=cm,
                  engine_factory=factory)
    base = f"http://127.0.0.1:{port}"
    try:
        # management surfaces are up before any model exists
        h = _get(base, "/health")
        assert h["ok"] and not h["loaded"] and h["model"] is None
        assert len(_get(base, "/models")) >= 12
        assert _get(base, "/config")["selected_model"] is None
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            assert b"<html" in r.read()[:200].lower()

        # transcription verbs refuse cleanly (409, JSON error body)
        code, body = _status_of(base, "/transcribe",
                                data=np.zeros(1600, "<f4").tobytes())
        assert code == 409 and "no model loaded" in body["error"]
        code, body = _status_of(base, "/sessions", data=b"{}")
        assert code == 409 and "no model loaded" in body["error"]

        # first-run flow: download via the injected opener, then select
        code, body = _status_of(base, "/models/tiny/download")
        assert code == 200
        deadline = time.time() + 60
        while time.time() < deadline:
            st = next(m for m in _get(base, "/models")
                      if m["id"] == "tiny")["status"]
            if st == "downloaded":
                break
            time.sleep(0.05)
        assert st == "downloaded"

        code, body = _status_of(
            base, "/config",
            data=json.dumps({"selected_model": "tiny"}).encode())
        assert code == 200 and built == ["tiny"]
        assert _get(base, "/health")["loaded"]

        # and transcription now works end-to-end on the downloaded model
        audio = sine_audio(1.0)
        out = _post(base, "/transcribe", audio.astype("<f4").tobytes())
        assert "text" in out and "segments" in out
    finally:
        httpd.shutdown()


def test_cmd_serve_boots_without_model(tmp_path, monkeypatch):
    """The CLI serve verb no longer exits(2) on an empty config — it
    passes engine=None plus the factory to serve()."""
    import argparse

    from nobs_whisper_torch import cli as climod

    captured = {}

    def fake_serve(engine, host, port, config_manager, engine_factory,
                   **kw):
        captured["engine"] = engine
        captured["factory"] = engine_factory

    monkeypatch.setattr("nobs_whisper_torch.serve.server.serve", fake_serve)
    args = argparse.Namespace(
        model=None, host="127.0.0.1", port=0, batch=1, mesh=None,
        dtype="float32", quant="none", warmup=False, speculative=0,
        draft_model=None, audio_ctx=0, device="cpu", sample_len=0,
        temperature_increment=None, rss_watermark_mb=0.0)
    climod.cmd_serve(args)
    assert captured["engine"] is None
    assert callable(captured["factory"])


def test_drain_verb_refuses_new_sessions(server):
    """POST /drain: new sessions 503 (DrainingError), /stats + /health
    report draining, existing machinery keeps working; /undrain
    restores. The backend half of the rolling-restart protocol
    (serve/router.py BackendManager)."""
    import urllib.error
    base, httpd = server
    # a session created BEFORE the drain keeps working through it
    sid = _post(base, "/sessions", json.dumps(
        {"language": "en", "sample_rate": 16000}).encode())["session"]
    try:
        r = _post(base, "/drain")
        assert r["draining"] is True
        assert _get(base, "/stats")["host"]["draining"] is True
        assert _get(base, "/health")["draining"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/sessions", b"{}")
        assert e.value.code == 503
        # pre-drain session still serves its verbs
        assert "started" in _post(base, f"/sessions/{sid}/start")
        assert "state" in _post(base, f"/sessions/{sid}/cancel")
    finally:
        r = _post(base, "/undrain")
    assert r["draining"] is False
    sid2 = _post(base, "/sessions", b"{}")["session"]
    for s in (sid, sid2):
        req = urllib.request.Request(base + f"/sessions/{s}",
                                     method="DELETE")
        urllib.request.urlopen(req, timeout=30).read()


def test_stats_host_gauges(server):
    """/stats carries the restart-planning gauges: a real RSS reading
    and the watermark/draining flags."""
    base, _ = server
    host = _get(base, "/stats")["host"]
    assert host["rss_mb"] > 10.0            # a live python process
    assert host["draining"] is False
    assert "rss_watermark_mb" in host
    assert host["sessions"] >= 0


def test_rss_watermark_monitor_drains(tmp_path_factory):
    """serve(rss_watermark_mb=tiny) flips the backend to draining via
    the monitor thread (real RSS is far above 1 MB)."""
    import socket
    from nobs_whisper_torch.serve.server import serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(None, port=port, background=True, rss_watermark_mb=1.0)
    try:
        base = f"http://127.0.0.1:{port}"
        t0 = time.time()
        while time.time() - t0 < 15:
            if _get(base, "/stats")["host"]["draining"]:
                break
            time.sleep(0.5)
        assert _get(base, "/stats")["host"]["draining"] is True
    finally:
        httpd.shutdown()
