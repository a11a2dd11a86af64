"""Command-line interface of the PyTorch port.

Usage:
  python -m nobs_whisper_torch.cli transcribe FILE... [--model PATH|ID]
      [--dtype bfloat16|float32] [--language L] [--task transcribe|translate]
      [--batch N] [--json] [--output-format txt|srt|vtt|tsv|json]
      [--output PATH] [--device cuda|cpu] [--word-timestamps]
      [--speculative K [--draft-pool P]]
  python -m nobs_whisper_torch.cli serve [--host H] [--port P]
      [--model PATH|ID] [--batch N] [--quant int8|none] [--warmup]
      [--device cuda|cpu] [--speculative K [--draft-pool P]
      [--draft-model PATH|ID]]
  python -m nobs_whisper_torch.cli route --backends URL[,URL...]
      [--manage CMD]... [--restart-interval-s S] [--rss-watermark-mb MB]
  python -m nobs_whisper_torch.cli models list|download|delete [ID]
  python -m nobs_whisper_torch.cli config get|set key=value [...]

As the JAX package's verbs. ``--model`` takes a GGML ``.bin`` path or an
id of the registry (``serve/models.py``), and falls back to the configured
``selected_model``. Every verb that loads a model runs on the card unless
``--device cpu`` is given; with no card it raises. ``transcribe
--beam-size K`` and a configured ``beam_size`` decode by beam search;
``--speculative K`` decodes greedy batches by exact speculative greedy
(the model drafting for itself over ``--draft-pool`` x pooled cross-KV,
or ``serve --draft-model``). ``route`` fronts N ``serve`` backends (one
process each, one card each); with ``--manage`` it spawns and
rolling-restarts them. ``serve --mesh DPxTP`` serves on a dp x tp device
mesh (``parallel/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional


def _load_engine(model: Optional[str], dtype: str, device: str,
                 audio_ctx: int = 0):
    import torch

    from .api import WhisperEngine
    from .serve.config import load_config
    from .serve.models import model_path

    model = model or load_config().selected_model
    if model is None:
        print("no model selected; pass --model or set config",
              file=sys.stderr)
        sys.exit(2)
    path = model if model.endswith(".bin") else str(model_path(model))
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    engine = WhisperEngine.from_ggml(path, dtype=dt, device=device)
    if audio_ctx:
        engine = engine.with_audio_ctx(audio_ctx)
    return engine


def cmd_transcribe(args):
    from .audio.io import load_audio
    from .audio.resample import resample
    from .decode.rules import DecodeOptions

    engine = _load_engine(args.model, args.dtype, args.device,
                          audio_ctx=args.audio_ctx)
    opts = DecodeOptions(
        beam_size=args.beam_size if args.beam_size > 1 else None,
        best_of=max(args.best_of, 1),
        temperature=args.temperature,
        temperature_increment=max(args.temperature_increment, 0.0),
        logprob_threshold=args.logprob_threshold,
        entropy_threshold=args.entropy_threshold,
        no_speech_threshold=args.no_speech_threshold,
        compression_ratio_threshold=args.compression_ratio_threshold,
        timestamps=not args.no_timestamps,
        word_timestamps=args.word_timestamps,
        speculative=max(args.speculative, 0),
        draft_pool=(max(args.draft_pool, 1)
                    if args.draft_pool is not None else 4))
    files = args.file
    batch = max(args.batch, 1)
    if batch > 1 and args.word_timestamps:
        print("--word-timestamps needs the sequential path; "
              "ignoring --batch", file=sys.stderr)
        batch = 1
    batched = None
    if batch > 1 and len(files) > 1:
        from .pipeline.batched_engine import BatchedEngine
        batched = BatchedEngine(engine, opts=opts,
                                max_batch=min(batch, len(files)))

    def run_one(path):
        audio, rate = load_audio(path)
        audio = resample(audio, rate)
        return (batched or engine).transcribe(
            audio, language=args.language, vocabulary=args.vocabulary,
            task=args.task, opts=opts)

    if batched is not None:
        from concurrent.futures import ThreadPoolExecutor
        try:
            with ThreadPoolExecutor(max_workers=batch) as ex:
                results = list(ex.map(run_one, files))
        finally:
            batched.close()
    else:
        results = [run_one(f) for f in files]

    multi = len(files) > 1
    written = set()
    for path, result in zip(files, results):
        if args.output_format:
            from .utils.writers import write_result
            if args.output and multi:
                # several inputs: --output is a directory of sidecars;
                # same-basename inputs get a numeric suffix
                os.makedirs(args.output, exist_ok=True)
                stem = os.path.splitext(os.path.basename(path))[0]
                out = os.path.join(args.output,
                                   stem + "." + args.output_format)
                n = 2
                while out in written:
                    out = os.path.join(
                        args.output, f"{stem}-{n}." + args.output_format)
                    n += 1
                written.add(out)
            else:
                out = args.output or os.path.splitext(path)[0] + \
                    "." + args.output_format
            write_result(result, out, args.output_format)
            print(f"wrote {out}")
        elif args.json:
            rec = {
                "text": result.text,
                "language": result.language,
                "segments": [dataclasses.asdict(s)
                             for s in result.segments]}
            if multi:
                rec = {"file": path, **rec}
            print(json.dumps(rec))
        else:
            if multi:
                print(f"== {path} ==")
            for seg in result.segments:
                print(f"[{seg.start:7.2f} --> {seg.end:7.2f}] {seg.text}")
            print(result.text)


def _default_batch(model: Optional[str]) -> int:
    """Default ``serve --batch`` by model: the JAX package's per-model
    throughput knees, measured on its TPU and kept for behaviour parity;
    none of them was measured on the card. Distil/quantized variants take
    their parent architecture's value; unknown ids take the turbo value.
    Only the basename is matched, never directory components
    (``/data/smallville/ggml-large-v3.bin`` is large-v3, not small)."""
    name = os.path.basename((model or "").lower())
    for key, knee in (("tiny", 192), ("base", 96), ("small", 48),
                      ("medium", 32), ("turbo", 40),
                      ("distil-large", 40), ("large", 24)):
        if key in name:
            return knee
    return 40


def _default_beam_batch(model: Optional[str], beam_size: int) -> int:
    """Default ``serve --batch`` under a beam strategy: the decode loop
    scales with the flattened rows (batch x beam), so the batch is about
    120 rows over the beam width, clamped to the greedy default (beam
    never batches more windows than greedy), ``max(1, min(
    _default_batch(model), 120 // beam_size))``. The 120-row budget is the
    JAX package's, measured on its TPU and kept for behaviour parity; it
    was not measured on the card."""
    return max(1, min(_default_batch(model), 120 // max(beam_size, 1)))


def _parse_mesh(spec: str, device: str):
    """``--mesh DPxTP`` -> a mesh over the first dp*tp visible cards
    (``--device cpu``: the CPU named dp*tp times); fewer cards than that
    raise. DPxTP only, as the reference parses it: pp and sp
    (``parallel/pipeline.py``, ``parallel/seqparallel.py``) serve nothing,
    and a third factor is a malformed spec."""
    import torch

    from .parallel.mesh import make_mesh
    parts = spec.lower().split("x")
    try:
        if len(parts) > 2:
            raise ValueError(spec)
        dp, tp = int(parts[0]), int(parts[1]) if len(parts) > 1 else 1
    except ValueError:
        raise SystemExit(f"--mesh {spec}: expected DPxTP, e.g. 2x1")
    if torch.device(device).type == "cpu":
        return make_mesh(dp=dp, tp=tp, device="cpu")
    n = torch.cuda.device_count()
    if n < dp * tp:
        raise ValueError(f"--mesh {spec} needs {dp * tp} cards, found {n}")
    return make_mesh(dp=dp, tp=tp,
                     devices=[torch.device("cuda", i) for i in range(dp * tp)])


def cmd_serve(args):
    from .core.device import resolve_device
    from .serve.config import ConfigManager
    from .serve.server import serve

    # the card unless --device cpu: with no card this raises here, before
    # anything is served
    resolve_device(args.device)
    cm = ConfigManager()
    explicit_batch = args.batch       # 0 = auto (per-model default)
    mesh = _parse_mesh(args.mesh, args.device) if args.mesh else None

    def build_engine(model_id, warmup=False):
        """model id/path -> ready serving engine on ``--device``, with the
        startup's quantization, audio_ctx and batching. Also the /config
        hot-swap factory: a selected_model change rebuilds through here,
        with the new model's default batch when --batch was auto."""
        engine = _load_engine(model_id, args.dtype, args.device,
                              audio_ctx=args.audio_ctx)
        if args.quant == "int8":
            # serving default: int8 decoder weights + dynamic-int8 encoder
            engine = engine.quantize()
        mid = model_id or cm.config.selected_model
        beam_k = cm.config.beam_size or 1
        batch = explicit_batch or (
            _default_beam_batch(mid, beam_k) if beam_k > 1
            else _default_batch(mid))
        if mesh is not None:
            # the batcher requires max_batch % dp == 0: round the (maybe
            # default) batch down to a dp multiple rather than fail for a
            # dp that does not divide it. batch <= 1 is the sequential
            # mode (no BatchedEngine): left as is.
            dp_n = mesh.shape["dp"]
            if batch > 1 and batch % dp_n:
                adj = max((batch // dp_n) * dp_n, dp_n)
                print(f"rounding --batch {batch} -> {adj} "
                      f"(must be divisible by dp={dp_n})", file=sys.stderr)
                batch = adj
        if batch > 1:
            from .decode.rules import DecodeOptions
            from .pipeline.batched_engine import BatchedEngine
            # decode strategy from the persisted config; sessions can
            # still override it per request
            app = cm.config
            okw = {}
            if args.sample_len:
                # decode-length cap per window (operator knob; also what
                # bounds random-weight checkpoints, which never emit EOT)
                okw["sample_len"] = args.sample_len
            if args.temperature_increment is not None:
                okw["temperature_increment"] = args.temperature_increment
            opts = DecodeOptions(
                beam_size=app.beam_size if app.beam_size > 1 else None,
                best_of=max(app.best_of, 1),
                temperature=float(app.temperature),
                task=str(app.task or "transcribe"), **okw)
            speculative = args.speculative
            if speculative and beam_k > 1:
                print("--speculative applies to greedy batches only; the "
                      "configured beam strategy routes batches through "
                      "the beam path — ignoring", file=sys.stderr)
                speculative = 0
            draft_engine = None
            if speculative and args.draft_model:
                # the draft scores the TARGET's encoder states: its
                # vocabulary and encoder width must match (checked again
                # on a /config hot-swap, which re-pairs the fixed draft)
                draft_engine = _load_engine(args.draft_model, args.dtype,
                                            args.device,
                                            audio_ctx=args.audio_ctx)
                tc, dc = engine.cfg, draft_engine.cfg
                if (tc.n_vocab != dc.n_vocab
                        or tc.n_audio_state != dc.n_audio_state):
                    print(f"draft {args.draft_model} incompatible with "
                          f"target {mid} (vocab {dc.n_vocab} vs "
                          f"{tc.n_vocab}, width {dc.n_audio_state} vs "
                          f"{tc.n_audio_state}); disabling speculative "
                          "decode for this engine", file=sys.stderr)
                    draft_engine = None
                    speculative = 0
                elif args.quant == "int8":
                    draft_engine = draft_engine.quantize()
            elif args.draft_model:
                print("--draft-model needs --speculative; ignoring",
                      file=sys.stderr)
            engine = BatchedEngine(engine, opts=opts, max_batch=batch,
                                   mesh=mesh, speculative=speculative,
                                   draft_pool=getattr(args, "draft_pool",
                                                      None),
                                   draft_engine=draft_engine)
            if warmup:
                import time
                t0 = time.perf_counter()
                print("warming the batcher (one batch of each size)…",
                      file=sys.stderr)
                sizes = engine.warmup()
                print(f"warmup done: sizes {sizes} in "
                      f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        elif warmup or args.speculative:
            flags = " ".join(f for f, on in
                             (("--warmup", warmup),
                              ("--speculative", args.speculative)) if on)
            print(f"{flags} applies to batched serving (--batch > 1); "
                  "ignoring", file=sys.stderr)
        return engine

    # startup-only warmup: a hot-swapped model warms lazily instead of
    # blocking the /config POST
    if args.model or cm.config.selected_model:
        engine = build_engine(args.model, warmup=args.warmup)
    else:
        # model-less first launch: serve /, /models, downloads and /config
        # with no engine; the first selection builds one through the
        # hot-swap factory, and transcription verbs answer 409 until then
        print("no model selected; serving in setup mode — pick a model "
              "in the web UI or POST /config {\"selected_model\": ...}",
              file=sys.stderr)
        engine = None
    serve(engine, host=args.host, port=args.port, config_manager=cm,
          engine_factory=build_engine,
          rss_watermark_mb=args.rss_watermark_mb)


def cmd_route(args):
    from .serve.router import ManagedBackend, serve_router

    urls = [b for b in args.backends.split(",") if b]
    if args.manage and len(args.manage) != len(urls):
        raise SystemExit(f"--manage given {len(args.manage)} times for "
                         f"{len(urls)} backends (must match, index-paired)")
    backends = []
    for i, url in enumerate(urls):
        if args.manage:
            import shlex
            log_path = None
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                log_path = os.path.join(args.log_dir, f"backend-{i}.log")
            backends.append(ManagedBackend(
                url, shlex.split(args.manage[i]), log_path=log_path))
        else:
            backends.append(url)
    kw = {}
    if args.manage:
        kw = dict(rss_watermark_mb=args.rss_watermark_mb,
                  restart_interval_s=args.restart_interval_s,
                  drain_timeout_s=args.drain_timeout_s,
                  health_timeout_s=args.health_timeout_s)
    serve_router(backends, host=args.host, port=args.port, **kw)


def cmd_models(args):
    from .serve import models as m

    if args.action == "list":
        for info in m.list_models():
            mark = {"downloaded": "*", "downloading": "~"}.get(info.status,
                                                               " ")
            print(f"[{mark}] {info.id:20s} {info.category:15s} "
                  f"{info.description}")
    elif args.action == "download":
        path = m.download_model(args.id)
        print(f"downloaded to {path}")
    elif args.action == "delete":
        print("deleted" if m.delete_model(args.id) else "not present")


def cmd_config(args):
    from .serve.config import ConfigManager

    mgr = ConfigManager()
    if args.action == "get":
        print(json.dumps(mgr.config.to_dict(), indent=2))
    else:
        changes = {}
        for kv in args.pairs:
            k, _, v = kv.partition("=")
            cur = getattr(mgr.config, k)  # raises for unknown keys
            if isinstance(cur, bool):
                changes[k] = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                changes[k] = int(v)
            else:
                changes[k] = v
        mgr.update(**changes)
        print(json.dumps(mgr.config.to_dict(), indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="nobs-whisper-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("transcribe", help="transcribe audio file(s)")
    t.add_argument("file", nargs="+",
                   help="audio file(s); several files with --batch N "
                        "share one device batch")
    t.add_argument("--batch", type=int, default=1,
                   help="transcribe up to N files concurrently through "
                        "one shared window batcher (1 = sequential)")
    t.add_argument("--model", default=None,
                   help="model id or GGML .bin path (default: the "
                        "configured selected_model)")
    t.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    t.add_argument("--language", default=None)
    t.add_argument("--vocabulary", default=None)
    t.add_argument("--beam-size", type=int, default=1)
    t.add_argument("--task", choices=["transcribe", "translate"],
                   default="transcribe")
    t.add_argument("--no-timestamps", action="store_true")
    t.add_argument("--word-timestamps", action="store_true")
    t.add_argument("--temperature", type=float, default=0.0)
    t.add_argument("--temperature-increment", type=float, default=0.2,
                   help="fallback ladder step; 0 disables the ladder")
    t.add_argument("--best-of", type=int, default=1)
    t.add_argument("--logprob-threshold", type=float, default=-1.0)
    t.add_argument("--entropy-threshold", type=float, default=2.4)
    t.add_argument("--no-speech-threshold", type=float, default=0.6)
    t.add_argument("--compression-ratio-threshold", type=float,
                   default=2.4)
    t.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="exact speculative greedy decode (K drafted "
                        "tokens a pass, token-identical output; 0 = off)")
    t.add_argument("--draft-pool", type=int, default=None, metavar="P",
                   help="cross-KV time pooling of the self-draft "
                        "(--speculative; default 4)")
    t.add_argument("--output-format",
                   choices=["txt", "srt", "vtt", "tsv", "json"],
                   default=None)
    t.add_argument("--output", default=None)
    t.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    t.add_argument("--audio-ctx", type=int, default=0, metavar="N",
                   help="truncate the encoder context to N positions "
                        "(windows become N*0.02 s); 0 = full context")
    t.add_argument("--json", action="store_true")
    t.set_defaults(fn=cmd_transcribe)

    s = sub.add_parser("serve", help="run the session API server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8777)
    s.add_argument("--model", default=None,
                   help="model id or GGML .bin path (default: the "
                        "configured selected_model; none = setup mode)")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    s.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    s.add_argument("--batch", type=int, default=0,
                   help="max cross-session window batch (1 = sequential; "
                        "0 = the model's default, e.g. 40 for "
                        "large-v3-turbo)")
    s.add_argument("--quant", choices=["int8", "none"], default="int8",
                   help="int8 serving path (default; 'none' = raw dtype)")
    s.add_argument("--mesh", default=None, metavar="DPxTP",
                   help="serve on a dp x tp mesh of the first dp*tp cards "
                        "(DPxTP only), e.g. 2x1 (each window batch split "
                        "over 2 cards) or 1x2 (each layer's heads and FFN "
                        "columns split over 2); --batch is rounded down to "
                        "a multiple of dp")
    s.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="exact speculative greedy decode with K drafted "
                        "tokens a pass (token-identical output; 0 = off). "
                        "Default draft: the model itself over 4x "
                        "time-pooled cross-KV")
    s.add_argument("--draft-pool", type=int, default=None, metavar="P",
                   help="cross-KV time pooling of the self-draft "
                        "(--speculative)")
    s.add_argument("--draft-model", default=None, metavar="ID|PATH",
                   help="second-model draft for --speculative (e.g. "
                        "distil-large-v3 drafting large-v3-turbo; must "
                        "share the vocabulary and encoder width), "
                        "quantized like the target")
    s.add_argument("--audio-ctx", type=int, default=0, metavar="N",
                   help="truncate the encoder context to N positions for "
                        "every session/window; 0 = full context")
    s.add_argument("--warmup", action="store_true",
                   help="run one batch of each size before accepting "
                        "traffic")
    s.add_argument("--sample-len", type=int, default=0,
                   help="cap decoded tokens per 30 s window (0 = model "
                        "default n_text_ctx/2)")
    s.add_argument("--temperature-increment", type=float, default=None,
                   help="fallback-ladder step (0 disables retries; "
                        "default: DecodeOptions' 0.2)")
    s.add_argument("--rss-watermark-mb", type=float, default=0.0,
                   help="self-drain when host RSS exceeds this (MB): new "
                        "sessions 503 and /stats reports draining; 0 = off")
    s.set_defaults(fn=cmd_serve)

    r = sub.add_parser("route", help="fan-out front end over N backend "
                                     "servers (one process, one card each)")
    r.add_argument("--backends", required=True,
                   help="comma-separated backend base URLs, e.g. "
                        "http://host1:8777,http://host2:8777")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=8700)
    r.add_argument("--manage", action="append", default=[], metavar="CMD",
                   help="spawn and rolling-restart the i-th backend with "
                        "this command (repeat once per backend, index-"
                        "paired; shell-split): drain, wait for its "
                        "sessions, SIGTERM, respawn, rejoin, one backend "
                        "at a time, with requests queued through the gap")
    r.add_argument("--rss-watermark-mb", type=float, default=0.0,
                   help="roll a managed backend when its /stats RSS gauge "
                        "exceeds this (MB); 0 = off")
    r.add_argument("--restart-interval-s", type=float, default=0.0,
                   help="also roll each managed backend every N seconds "
                        "(time-based rolling; 0 = off)")
    r.add_argument("--drain-timeout-s", type=float, default=180.0)
    r.add_argument("--health-timeout-s", type=float, default=900.0)
    r.add_argument("--log-dir", default=None,
                   help="write each managed backend's stdout/stderr to "
                        "<log-dir>/backend-<i>.log")
    r.set_defaults(fn=cmd_route)

    mdl = sub.add_parser("models", help="manage model files")
    mdl.add_argument("action", choices=["list", "download", "delete"])
    mdl.add_argument("id", nargs="?")
    mdl.set_defaults(fn=cmd_models)

    c = sub.add_parser("config", help="show or change config")
    c.add_argument("action", choices=["get", "set"])
    c.add_argument("pairs", nargs="*", help="key=value")
    c.set_defaults(fn=cmd_config)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
