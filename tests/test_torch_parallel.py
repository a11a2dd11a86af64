"""The port's dp x tp mesh (``nobs_whisper_torch/parallel/``) on the CPU:
the reference's ``tests/test_parallel.py`` cases but the train step and
the ``__graft_entry__`` ones (mesh construction, the spec tree covering
the params, sharded encode and window decode, quantized
``shard_params``, the batcher in mesh mode), then the port held to the
JAX package on the same seeded weights at f32, with JAX on its 8 virtual
CPU devices: the dp=8 and dp=4 x tp=2 batchers' tokens, the tp=2 encoder
states (float and int8) against GSPMD's, ``shard_params`` slice for
slice, the int8 row-scale trap, and each shard body in its own thread
under its device's context; and ``serve --mesh`` on the CPU.

The port's CPU stand-in for the 8 virtual devices is the CPU named dp * tp
times (``make_mesh(..., device="cpu")``)."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tiny_cfg(name="par-test"):
    from nobs_whisper_torch.core.config import WhisperConfig
    return WhisperConfig(
        name=name, n_mels=80, n_vocab=1024, n_audio_ctx=32,
        n_audio_state=128, n_audio_head=4, n_audio_layer=2,
        n_text_ctx=32, n_text_state=128, n_text_head=4, n_text_layer=2,
        n_langs=4, eot_id=1000, force_multilingual=True)


def _jax_params(seed=0, quant=False):
    """The JAX package's params at f32, and the port's copy of them."""
    from nobs_whisper_tpu.models.whisper import init_params
    from nobs_whisper_tpu.ops.quant import (quantize_decoder_params,
                                            quantize_encoder_params)
    from nobs_whisper_torch.models.whisper import params_from_jax
    p = init_params(jax.random.PRNGKey(seed), _tiny_cfg())
    if quant:
        p = quantize_encoder_params(quantize_decoder_params(p))
    return p, params_from_jax(jax.tree.map(np.asarray, p))


def _mesh(dp, tp):
    from nobs_whisper_torch.parallel.mesh import make_mesh
    return make_mesh(dp=dp, tp=tp, device="cpu")


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_mesh_construction():
    from nobs_whisper_torch.parallel.mesh import CPU_DEVICE_COUNT, make_mesh
    mesh = make_mesh(dp=4, tp=2, device="cpu")
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert sum(len(row) for row in mesh.devices) == 8
    assert make_mesh(device="cpu").shape == {"dp": CPU_DEVICE_COUNT,
                                             "tp": 1}
    assert make_mesh(tp=2, device="cpu").shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError):
        make_mesh(dp=3, tp=2, devices=["cpu"] * 8)
    # one device named twice: dp=2 on a one-card machine
    two = make_mesh(dp=2, devices=["cpu", "cpu"])
    assert two.devices == ((torch.device("cpu"),), (torch.device("cpu"),))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(dp=2)      # the default is every card


@pytest.mark.parametrize("quant", [False, True])
def test_param_pspec_tree_covers_params(quant):
    """Every param leaf has an explicit spec naming its tp axis (specs may
    carry keys, e.g. tok_emb_q, that exist only after quantization)."""
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.ops.quant import (is_quantized,
                                              quantize_decoder_params,
                                              quantize_encoder_params)
    from nobs_whisper_torch.parallel.mesh import param_pspecs
    params = init_params(0, _tiny_cfg())
    if quant:
        params = quantize_encoder_params(quantize_decoder_params(params))
    specs = param_pspecs(params)

    def walk(p, s, path=""):
        if isinstance(p, dict) and not is_quantized(p):
            for k, v in p.items():
                assert isinstance(s, dict) and k in s, \
                    f"no spec for {path}/{k}"
                walk(v, s[k], f"{path}/{k}")
        else:
            assert isinstance(s, tuple), f"spec for {path} is a subtree"
            t = p["q"] if is_quantized(p) else p
            assert len(s) == t.ndim, path
            assert s.count("tp") <= 1

    walk(params, specs)


def test_sharded_encode_matches_single_device():
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    mel = torch.from_numpy(
        np.random.RandomState(0).randn(8, 80, 64).astype(np.float32))
    expected = encode(params, mel, cfg).numpy()
    got = encode_spmd(params, mel, _mesh(4, 2), cfg).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)


def test_sharded_decode_window_matches_single_device():
    """The serving decode loop under dp=4 x tp=2 equals single-device
    decode token for token."""
    from nobs_whisper_torch.decode.greedy import (decode_window,
                                                  decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import encode, init_params
    from nobs_whisper_torch.parallel.mesh import shard_params
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    mel = torch.from_numpy(
        np.random.RandomState(1).randn(8, 80, 64).astype(np.float32))
    opts = DecodeOptions()
    tables = build_rule_tables(cfg, opts)
    prompts = [[cfg.sot, cfg.lang_base + (i % 4), cfg.transcribe]
               for i in range(8)]
    expected = decode_window(params, encode(params, mel, cfg), prompts, cfg,
                             tables, opts)

    mesh = _mesh(4, 2)
    sparams = shard_params(params, mesh)
    sxa = encode_spmd(sparams, mel, mesh, cfg)
    got = decode_window_finalize(decode_window_dispatch(
        sparams, sxa, prompts, cfg, tables, opts, mesh=mesh))
    for e, g in zip(expected, got):
        assert g.tokens == e.tokens
        assert g.sum_logprob == pytest.approx(e.sum_logprob, rel=1e-3,
                                              abs=1e-3)
        assert g.no_speech_prob == pytest.approx(e.no_speech_prob,
                                                 rel=1e-3, abs=1e-4)


def test_shard_params_quantized():
    """Int8 params shard: q takes the weight's split, s drops the
    contraction axis's; a sharded quantized decode still runs."""
    from nobs_whisper_torch.decode.greedy import (decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.parallel.mesh import shard_params
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    cfg = _tiny_cfg()
    params = quantize_decoder_params(init_params(0, cfg))
    mesh = _mesh(4, 2)
    sparams = shard_params(params, mesh)
    full = params["decoder"]["blocks"]
    for j in range(2):
        blk = sparams.trees[0][j]["decoder"]["blocks"]
        assert blk["q_w"]["q"].shape == (2, 128, 64)      # out split
        assert blk["q_w"]["s"].shape == (2, 1, 64)
        assert torch.equal(blk["q_w"]["q"],
                           full["q_w"]["q"][..., 64 * j:64 * (j + 1)])
        assert blk["o_w"]["q"].shape == (2, 64, 128)      # in split
        # s has K = 1: the contraction axis's split is dropped
        assert torch.equal(blk["o_w"]["s"], full["o_w"]["s"])
        assert sparams.trees[0][j]["decoder"]["tok_emb_q"]["q"].shape == \
            (128, 512)
    assert sparams.vocab == [(0, 512), (512, 1024)]

    mel = torch.from_numpy(
        np.random.RandomState(2).randn(8, 80, 64).astype(np.float32))
    tables = build_rule_tables(cfg, DecodeOptions())
    sxa = encode_spmd(sparams, mel, mesh, cfg)
    res = decode_window_finalize(decode_window_dispatch(
        sparams, sxa, [[cfg.sot, cfg.lang_base, cfg.transcribe]] * 8, cfg,
        tables, DecodeOptions(), mesh=mesh))
    assert all(np.isfinite(r.sum_logprob) for r in res)


def _windows(cfg, n=4, seed=20):
    from nobs_whisper_torch.audio.mel import HOP_LENGTH, log_mel_longform
    from nobs_whisper_torch.utils.testing import speech_like_audio
    wf = 2 * cfg.n_audio_ctx
    return [log_mel_longform(speech_like_audio(0.3, seed=seed + i),
                             n_mels=cfg.n_mels, padding=wf * HOP_LENGTH,
                             device="cpu")[:, :wf]
            for i in range(n)]


_OPTS = dict(logprob_threshold=-1e9, entropy_threshold=0.0,
             no_speech_threshold=1.1, compression_ratio_threshold=1e9)


def _run(b, windows, prompt, **kw):
    try:
        futs = [b.submit(w, prompt, **kw) for w in windows]
        return [f.result(timeout=300) for f in futs]
    finally:
        b.close()


def test_batcher_mesh_mode_matches_unsharded():
    """WindowBatcher(mesh=...) returns the unsharded batcher's tokens for
    the same requests."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    cfg = _tiny_cfg()
    params = init_params(0, cfg)
    opts = DecodeOptions(**_OPTS)
    windows = _windows(cfg)
    prompt = [cfg.sot, cfg.lang_base, cfg.transcribe]
    kw = dict(opts=opts, max_batch=4, max_wait_ms=50, device="cpu")
    expected = _run(WindowBatcher(params, cfg, **kw), windows, prompt)
    got = _run(WindowBatcher(params, cfg, mesh=_mesh(4, 2), **kw), windows,
               prompt)
    assert [g.tokens for g in got] == [e.tokens for e in expected]


def test_batcher_mesh_requires_divisible_batch():
    from nobs_whisper_torch.models.whisper import init_params
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    cfg = _tiny_cfg()
    with pytest.raises(ValueError, match="divisible by dp"):
        WindowBatcher(init_params(0, cfg), cfg, max_batch=6,
                      mesh=_mesh(4, 1))


# ---------------------------------------------------------------------------
# the port against the JAX package (f32, same weights)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2)])
def test_batcher_mesh_matches_jax(dp, tp):
    """The port's dp=8 and dp=4 x tp=2 batchers give the JAX package's
    sharded batcher's tokens on the same weights at f32 (dp=8 is the
    reference's shard_map path, dp=4 x tp=2 its GSPMD path). Five
    requests: the batch pads to a multiple of dp with a real row."""
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JOpts
    from nobs_whisper_tpu.parallel.mesh import make_mesh as jmake
    from nobs_whisper_tpu.pipeline.batcher import WindowBatcher as JBatcher
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    cfg = _tiny_cfg()
    jparams, params = _jax_params(0)
    windows = _windows(cfg, n=5, seed=60)
    prompt = [cfg.sot, cfg.lang_base + 1, cfg.transcribe]
    ref = _run(JBatcher(jparams, cfg, opts=JOpts(**_OPTS), max_batch=8,
                        max_wait_ms=200, mesh=jmake(dp=dp, tp=tp)),
               windows, prompt)
    got = _run(WindowBatcher(params, cfg, opts=DecodeOptions(**_OPTS),
                             max_batch=8, max_wait_ms=200,
                             mesh=_mesh(dp, tp)), windows, prompt)
    assert [g.tokens for g in got] == [r.tokens for r in ref]
    for g, r in zip(got, ref):
        # f32 reassociation across packages and shardings
        assert g.sum_logprob == pytest.approx(r.sum_logprob, abs=1e-3)


@pytest.mark.parametrize("quant", [False, True])
def test_tp2_encode_matches_jax_gspmd(quant):
    """The port's tp=2 encoder states against the JAX package's GSPMD
    encode on the same weights; both run the plain path (the reference's
    kernel gates are off on more than one device, the port's tp ranks run
    plain). Float: within 1e-5 of the states' largest magnitude.

    int8: the port's tp=2 states equal its own unsharded plain int8 states
    bit for bit (the row absmax is taken across the ranks and the integer
    partial sums are added exactly), and are within two int8 steps (2/127
    of the largest magnitude) of GSPMD's. Across packages the f32 values
    entering each row quantization differ in their last bits (the conv,
    the LayerNorm sums), and a value that lies on a rounding boundary
    moves one int8 step, 1/127 of its row's absmax; the JAX package's own
    unsharded int8 encode differs from the port's by the same 0.0088 on
    this input, so this is no tp effect."""
    from nobs_whisper_tpu.models.whisper import encode as jencode
    from nobs_whisper_tpu.parallel.mesh import batch_sharding
    from nobs_whisper_tpu.parallel.mesh import make_mesh as jmake
    from nobs_whisper_tpu.parallel.mesh import shard_params as jshard
    from nobs_whisper_torch.models.whisper import encode
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    from nobs_whisper_torch.parallel.tp import ShardContext, shard_context
    cfg = _tiny_cfg()
    jparams, params = _jax_params(3, quant)
    mel = np.random.RandomState(4).randn(4, 80, 64).astype(np.float32)
    jmesh = jmake(dp=4, tp=2)
    ref = np.asarray(jencode(jshard(jparams, jmesh),
                             jax.device_put(mel, batch_sharding(jmesh)),
                             cfg))
    got = encode_spmd(params, torch.from_numpy(mel), _mesh(1, 2),
                      cfg).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < (2 / 127 if quant else 1e-5), err
    if quant:
        with shard_context(ShardContext(None, plain=True)):
            plain = encode(params, torch.from_numpy(mel), cfg).numpy()
        np.testing.assert_array_equal(got, plain)


def test_int8_row_scale_trap():
    """fc2's input is split over F under tp, and ``dense_int8_dynamic``
    takes one row scale over the whole contraction axis. The port's tp
    op takes the row absmax across the ranks and equals the unsharded op
    (and the JAX package's) bit for bit; with each rank's own scale the
    result is another function."""
    from nobs_whisper_tpu.ops.quant import dense_int8_dynamic as jdense
    from nobs_whisper_torch.ops.quant import (dense_int8_dynamic,
                                              quantize_int8)
    from nobs_whisper_torch.parallel.mesh import Mesh, ShardedParams
    from nobs_whisper_torch.parallel import tp as T
    from nobs_whisper_torch.parallel.spmd import run_on_mesh
    rng = np.random.RandomState(5)
    x = rng.randn(6, 512).astype(np.float32)
    x[:, 300:] *= 0.05        # the second rank's half is much smaller
    w = quantize_int8(torch.from_numpy(
        rng.randn(512, 128).astype(np.float32) * 0.05))
    xt = torch.from_numpy(x)
    want = dense_int8_dynamic(xt, w)
    ref = np.asarray(jdense(jnp.asarray(x), {"q": jnp.asarray(w["q"]),
                                             "s": jnp.asarray(w["s"])}))
    np.testing.assert_array_equal(want.numpy(), ref)

    halves = [{"q": w["q"][256 * r:256 * (r + 1)], "s": w["s"]}
              for r in range(2)]
    mesh = Mesh(((torch.device("cpu"), torch.device("cpu")),))
    sp = ShardedParams(mesh, [halves], [(0, 0), (0, 0)])
    # each rank gets its half of the features (the same rows)
    def body(wr, _):
        r = T.current().rank
        return T.row_dense_int8_dynamic(xt[:, 256 * r:256 * (r + 1)], wr)

    got = run_on_mesh(mesh, sp, body, ([0],))
    assert torch.equal(got, want)
    per_rank = sum(dense_int8_dynamic(xt[:, 256 * r:256 * (r + 1)],
                                      halves[r]) for r in range(2))
    assert not torch.allclose(per_rank, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_shard_params_matches_jax_slices(quant):
    """The weight bridge: ``shard_params`` of the port's converted tree
    equals, slice for slice, the JAX package's ``shard_params`` of the JAX
    tree read back with ``np.asarray`` (each device's addressable shard),
    at every (dp, tp) position of a 4 x 2 mesh."""
    from nobs_whisper_tpu.parallel.mesh import make_mesh as jmake
    from nobs_whisper_tpu.parallel.mesh import shard_params as jshard
    from nobs_whisper_torch.parallel.mesh import shard_params
    jparams, params = _jax_params(0, quant)
    jmesh = jmake(dp=4, tp=2)
    jsharded = jshard(jparams, jmesh)
    sparams = shard_params(params, _mesh(4, 2))
    devs = np.asarray(jmesh.devices)
    flat_j = jax.tree_util.tree_flatten_with_path(jsharded)[0]
    n = 0
    for path, arr in flat_j:
        keys = [p.key for p in path]
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for i in range(4):
            for j in range(2):
                node = sparams.trees[i][j]
                for k in keys:
                    node = node[k]
                np.testing.assert_array_equal(
                    node.numpy(), by_dev[devs[i, j]],
                    err_msg="/".join(map(str, keys)))
                n += 1
    assert n == 8 * len(flat_j)


def test_shard_bodies_run_in_threads_under_their_device(monkeypatch):
    """Each mesh position's body runs in a host thread of its own, inside
    ``torch.cuda.device(dev)`` for a card: the kernels launch on the
    current device's stream, so a shard on ``cuda:1`` launching from a
    thread whose current device is ``cuda:0`` would be a fault. The
    context manager is patched (no card here) and the tensors stay on the
    CPU."""
    import contextlib

    from nobs_whisper_torch.parallel import spmd
    from nobs_whisper_torch.parallel.mesh import Mesh, ShardedParams
    current = threading.local()
    entered = []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append((threading.current_thread().name, torch.device(dev)))
        current.dev = torch.device(dev)
        try:
            yield
        finally:
            current.dev = None

    cards = [torch.device("cuda", i) for i in range(4)]
    mesh = Mesh(((cards[0],), (cards[1],), (cards[2],), (cards[3],)))
    sp = ShardedParams(mesh, [[{"i": i}] for i in range(4)], [(0, 0)])
    seen = {}
    together = threading.Barrier(4, timeout=30)

    def body(p, rows):
        seen[p["i"]] = (threading.current_thread().name,
                        getattr(current, "dev", None), rows.tolist())
        together.wait()          # all four bodies are running at once
        return rows

    main = threading.current_thread().name
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(spmd, "_to", lambda x, dev: x)
    out = spmd.run_on_mesh(mesh, sp, body, (torch.arange(8),),
                           out_device=torch.device("cpu"))
    assert out.tolist() == list(range(8))
    idents = {v[0] for v in seen.values()}
    assert len(idents) == 4 and main not in idents
    for i in range(4):
        assert seen[i][1] == cards[i]
        assert seen[i][2] == [2 * i, 2 * i + 1]
    assert sorted(d.index for _, d in entered) == [0, 1, 2, 3]


def test_shard_failure_fails_the_call():
    """A shard that raises fails the whole call with its own exception
    (the batcher then fails the batch's rows); its tp peers, waiting at a
    collective, are released rather than left hanging."""
    from nobs_whisper_torch.parallel import tp as T
    from nobs_whisper_torch.parallel.mesh import ShardedParams
    from nobs_whisper_torch.parallel.spmd import run_on_mesh
    mesh = _mesh(2, 2)
    sp = ShardedParams(mesh, [[{"r": 0}, {"r": 1}]] * 2, [(0, 0)] * 2)

    def body(p, rows):
        if p["r"] == 1 and rows[0] == 1:
            raise KeyError("rank 1 of group 1")
        return T.reduce_partial(torch.ones(1))

    with pytest.raises(KeyError, match="rank 1 of group 1"):
        run_on_mesh(mesh, sp, body, ([0, 1],))


def test_cli_mesh_spec():
    """``serve --mesh DPxTP`` builds the mesh (``--device cpu``: the CPU
    named dp * tp times); a third factor (pp or sp) raises naming the
    last slice; a malformed spec exits."""
    from nobs_whisper_torch.cli import _parse_mesh
    assert _parse_mesh("2x1", "cpu").shape == {"dp": 2, "tp": 1}
    assert _parse_mesh("4", "cpu").shape == {"dp": 4, "tp": 1}
    assert _parse_mesh("1x2", "cpu").shape == {"dp": 1, "tp": 2}
    with pytest.raises(NotImplementedError, match="last slice"):
        _parse_mesh("1x2x2", "cpu")
    with pytest.raises(SystemExit):
        _parse_mesh("twoxone", "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, RuntimeError)):
            _parse_mesh("2x1", "cuda")       # more cards than there are


def test_serve_mesh_verb_on_the_cpu(tmp_path):
    """``serve --mesh 2x2 --batch 3 --device cpu`` rounds the batch down
    to a multiple of dp with the reference's message, answers a one-shot
    ``/transcribe`` through the mesh batcher and exits 0 on SIGINT."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = tmp_path / "ggml-tiny.bin"
    write_tiny_checkpoint(str(ckpt))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": repo, "HOME": str(tmp_path),
           "NOBS_WHISPER_TPU_HOME": str(tmp_path), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nobs_whisper_torch.cli", "serve",
         "--device", "cpu", "--model", str(ckpt), "--dtype", "float32",
         "--batch", "3", "--mesh", "2x2", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo, env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        end = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.monotonic() < end, "serve did not come up"
            try:
                with urllib.request.urlopen(base + "/health", timeout=5):
                    break
            except OSError:
                time.sleep(0.2)
        audio = np.random.RandomState(3).randn(16000) * 0.2
        req = urllib.request.Request(
            base + "/transcribe?language=en",
            data=audio.astype("<f4").tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert isinstance(out["text"], str) and out["language"] == "en"
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            # one request: a batch a rung of the fallback ladder
            assert json.loads(r.read())["batcher"]["recent_batches"] >= 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        assert "rounding --batch 3 -> 2 (must be divisible by dp=2)" in \
            proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
