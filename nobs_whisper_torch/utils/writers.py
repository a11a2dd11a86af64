"""Transcript output writers: txt / srt / vtt / json / tsv.

The whisper ecosystem's standard output formats (the reference app only
types text into the focused field; a framework user expects files)."""

from __future__ import annotations

import dataclasses
import json
from typing import IO, List


def _ts_srt(seconds: float) -> str:
    ms = int(round(seconds * 1000))
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def _ts_vtt(seconds: float) -> str:
    return _ts_srt(seconds).replace(",", ".")


def write_txt(result, f: IO[str]) -> None:
    f.write(result.text + "\n")


def write_srt(result, f: IO[str]) -> None:
    for i, seg in enumerate(result.segments, 1):
        f.write(f"{i}\n{_ts_srt(seg.start)} --> {_ts_srt(seg.end)}\n"
                f"{seg.text.strip()}\n\n")


def write_vtt(result, f: IO[str]) -> None:
    f.write("WEBVTT\n\n")
    for seg in result.segments:
        f.write(f"{_ts_vtt(seg.start)} --> {_ts_vtt(seg.end)}\n"
                f"{seg.text.strip()}\n\n")


def write_tsv(result, f: IO[str]) -> None:
    f.write("start\tend\ttext\n")
    for seg in result.segments:
        f.write(f"{int(seg.start * 1000)}\t{int(seg.end * 1000)}\t"
                f"{seg.text.strip()}\n")


def write_json(result, f: IO[str]) -> None:
    json.dump({
        "text": result.text,
        "language": result.language,
        "segments": [dataclasses.asdict(s) for s in result.segments],
    }, f, ensure_ascii=False)
    f.write("\n")


WRITERS = {
    "txt": write_txt,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
    "json": write_json,
}


def write_result(result, path: str, fmt: str) -> None:
    if fmt not in WRITERS:
        raise KeyError(f"unknown format {fmt!r}; have {sorted(WRITERS)}")
    with open(path, "w", encoding="utf-8") as f:
        WRITERS[fmt](result, f)
