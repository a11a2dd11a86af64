"""Command-line interface of the PyTorch port: the ``transcribe`` verb.

Usage:
  python -m nobs_whisper_torch.cli transcribe FILE... --model PATH.bin
      [--dtype bfloat16|float32] [--language L] [--task transcribe|translate]
      [--batch N] [--json] [--output-format txt|srt|vtt|tsv|json]
      [--output PATH] [--device cuda|cpu]

As the JAX package's ``transcribe`` verb: a GGML checkpoint loaded
unquantized in the compute dtype, files transcribed one by one (or up to
N at once through one shared window batcher with ``--batch N``). Runs on
the card unless ``--device cpu`` is given. Beam search, word timestamps
and speculative decoding are later slices of the port: asking for them
raises. Model ids of the JAX package's registry (``serve/models.py``)
come with the serving slice; give a ``.bin`` path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _load_engine(model, dtype: str, device: str, audio_ctx: int = 0):
    import torch

    from .api import WhisperEngine

    if model is None:
        print("no model selected; pass --model PATH.bin", file=sys.stderr)
        sys.exit(2)
    if not model.endswith(".bin"):
        raise NotImplementedError(
            f"model id {model!r}: the model registry is not ported yet "
            "(ROADMAP.md queue 1, item 8); pass a GGML .bin path")
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    engine = WhisperEngine.from_ggml(model, dtype=dt, device=device)
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
        speculative=max(args.speculative, 0))
    files = args.file
    batch = max(args.batch, 1)
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
    t.add_argument("--model", default=None, help="GGML .bin path")
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
    t.add_argument("--speculative", type=int, default=0, metavar="K")
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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
