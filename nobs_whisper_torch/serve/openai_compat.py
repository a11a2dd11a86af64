"""OpenAI-compatible audio API surface.

`POST /v1/audio/transcriptions`, `POST /v1/audio/translations`, and
`GET /v1/models`, wire-compatible with the OpenAI Whisper endpoints so
off-the-shelf clients (the `openai` SDK, existing curl scripts) can talk
to a running `nobs-whisper-tpu serve` without modification. This is a
capability layer beyond the reference app (which has no HTTP API at
all); it reuses the same engine/DecodeOptions plumbing as the native
`/transcribe` route. (Port of the JAX package's ``serve/openai_compat.py``;
model ids and ``owned_by`` are the JAX package's, so clients see one API.)

Multipart `multipart/form-data` bodies are parsed with the stdlib email
package — no web-framework dependency, matching serve/server.py.

Supported form fields (the OpenAI set):
  file                        required; WAV or raw f32 PCM payload
  model                       accepted and ignored (the server's loaded
                              model answers; mirrors /transcribe)
  language                    ISO-639-1 hint (transcriptions only)
  prompt                      initial-prompt conditioning text
  response_format             json | text | srt | vtt | verbose_json
  temperature                 sampling temperature (ladder base)
  timestamp_granularities[]   "word" and/or "segment" (verbose_json)

Errors use OpenAI's envelope: {"error": {"message", "type", "param",
"code"}}.
"""

from __future__ import annotations

import io
import json
from email.parser import BytesParser
from email.policy import HTTP as _HTTP_POLICY
from typing import Dict, List, Optional, Tuple

import numpy as np

RESPONSE_FORMATS = ("json", "text", "srt", "vtt", "verbose_json")


class OpenAIError(ValueError):
    """Carries the OpenAI error envelope fields."""

    def __init__(self, message: str, *, etype: str = "invalid_request_error",
                 param: Optional[str] = None, code: Optional[str] = None,
                 status: int = 400):
        super().__init__(message)
        self.etype = etype
        self.param = param
        self.code = code
        self.status = status

    def envelope(self) -> dict:
        return {"error": {"message": str(self), "type": self.etype,
                          "param": self.param, "code": self.code}}


def parse_multipart(body: bytes, content_type: str) -> Dict[str, List[Tuple[Optional[str], bytes]]]:
    """Parse a multipart/form-data body into name -> [(filename, value)].

    Repeated field names (OpenAI's `timestamp_granularities[]`) collect
    in order. Raises OpenAIError on a malformed body.
    """
    if not content_type or "multipart/form-data" not in content_type:
        raise OpenAIError(
            "expected a multipart/form-data body "
            f"(got Content-Type {content_type!r})")
    head = (b"Content-Type: " + content_type.encode("latin-1")
            + b"\r\nMIME-Version: 1.0\r\n\r\n")
    msg = BytesParser(policy=_HTTP_POLICY).parsebytes(head + body)
    if not msg.is_multipart():
        raise OpenAIError("could not parse multipart body "
                          "(missing or bad boundary)")
    fields: Dict[str, List[Tuple[Optional[str], bytes]]] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        if payload is None:  # pragma: no cover - empty part edge
            payload = b""
        fields.setdefault(str(name), []).append(
            (part.get_filename(), payload))
    return fields


def _text_field(fields, name: str) -> Optional[str]:
    vals = fields.get(name)
    if not vals:
        return None
    return vals[-1][1].decode("utf-8", "replace")


def _decode_audio(filename: Optional[str], blob: bytes) -> np.ndarray:
    """File payload -> 16 kHz mono float32. WAV (sniffed or by
    extension) and raw f32 PCM are supported; compressed formats need a
    decoder the package does not ship, so they get a clear 400."""
    from ..audio.io import read_wav
    from ..audio.resample import resample

    lower = (filename or "").lower()
    if blob[:4] == b"RIFF" or lower.endswith(".wav"):
        audio, rate = read_wav(blob)
        return resample(audio, rate)
    if lower.endswith((".pcm", ".f32", ".raw")) or not lower:
        if len(blob) % 4:
            raise OpenAIError(
                "raw PCM payload length is not a multiple of 4 "
                "(expected little-endian float32 samples)", param="file")
        return np.frombuffer(blob, "<f4").astype(np.float32)
    raise OpenAIError(
        f"unsupported audio format {filename!r}: this server decodes "
        "WAV (pcm16/24/32/f32) and raw little-endian f32 PCM",
        param="file")


def _compression_ratio(text: str) -> float:
    # the decoder's own metric (decode/rules.py) — the verbose_json
    # field must never diverge from the gate the decode actually used
    from ..decode.rules import compression_ratio
    return compression_ratio(text)


def _verbose_json(result, duration: float, task: str,
                  want_words: bool) -> dict:
    segments = []
    for seg in result.segments:
        segments.append({
            "id": seg.id,
            "seek": seg.seek,
            "start": round(float(seg.start), 3),
            "end": round(float(seg.end), 3),
            "text": seg.text,
            "tokens": list(seg.tokens),
            "temperature": float(seg.temperature),
            "avg_logprob": float(seg.avg_logprob),
            "compression_ratio": round(_compression_ratio(seg.text), 4),
            "no_speech_prob": float(seg.no_speech_prob),
        })
    out = {
        "task": task,
        "language": result.language,
        "duration": round(duration, 3),
        "text": result.text,
        "segments": segments,
    }
    if want_words:
        words = []
        for seg in result.segments:
            for w in seg.words or ():
                words.append({"word": w.word,
                              "start": round(float(w.start), 3),
                              "end": round(float(w.end), 3)})
        out["words"] = words
    return out


def handle_audio(handler, state, task: str) -> None:
    """POST /v1/audio/{transcriptions,translations} against a live
    ServerState. `handler` is the stdlib request handler (gives us the
    headers/body and response plumbing)."""
    try:
        _handle_audio(handler, state, task)
    except OpenAIError as e:
        _send(handler, e.envelope(), e.status)
    except ValueError as e:
        _send(handler, OpenAIError(str(e)).envelope(), 400)


def _handle_audio(handler, state, task: str) -> None:
    fields = parse_multipart(
        _read_body(handler), handler.headers.get("Content-Type", ""))
    files = fields.get("file")
    if not files:
        raise OpenAIError("you must provide a `file` form field",
                          param="file")
    filename, blob = files[-1]
    audio = _decode_audio(filename, blob)
    duration = len(audio) / 16000.0

    fmt = _text_field(fields, "response_format") or "json"
    if fmt not in RESPONSE_FORMATS:
        raise OpenAIError(
            f"invalid response_format {fmt!r}; expected one of "
            f"{list(RESPONSE_FORMATS)}", param="response_format")
    grans = [v[1].decode("utf-8", "replace")
             for v in (fields.get("timestamp_granularities[]") or [])
             + (fields.get("timestamp_granularities") or [])]
    for g in grans:
        if g not in ("word", "segment"):
            raise OpenAIError(
                f"invalid timestamp granularity {g!r}; expected "
                "'word' or 'segment'", param="timestamp_granularities")
    want_words = "word" in grans
    if grans and fmt != "verbose_json":
        raise OpenAIError(
            "timestamp_granularities requires "
            "response_format='verbose_json'",
            param="timestamp_granularities")

    temp_s = _text_field(fields, "temperature")
    try:
        temperature = float(temp_s) if temp_s else 0.0
    except ValueError:
        raise OpenAIError(f"temperature must be a number, got {temp_s!r}",
                          param="temperature")

    language = _text_field(fields, "language")
    if task == "translate":
        # the OpenAI translations endpoint has no language parameter;
        # tolerate-and-ignore if a client sends one anyway
        language = None
    if language in ("", "auto"):
        language = None

    app = state.config_manager.config
    from ..decode.rules import DecodeOptions
    opts = DecodeOptions(
        task=task, temperature=temperature,
        word_timestamps=want_words,
        # strategy knobs OpenAI does not expose inherit the server's
        # persisted configuration, same as the native /transcribe route
        beam_size=(app.beam_size if (app.beam_size or 1) > 1 else None),
        best_of=max(app.best_of or 1, 1))
    with state.borrow_engine() as engine:
        result = engine.transcribe(
            audio, language=language,
            vocabulary=app.custom_vocabulary or None,
            context=_text_field(fields, "prompt"),
            opts=opts)

    if fmt == "json":
        return _send(handler, {"text": result.text})
    if fmt == "verbose_json":
        return _send(handler,
                     _verbose_json(result, duration, task, want_words))
    if fmt == "text":
        return _send_raw(handler, result.text + "\n",
                         "text/plain; charset=utf-8")
    from ..utils.writers import WRITERS
    buf = io.StringIO()
    WRITERS[fmt](result, buf)
    ctype = ("application/x-subrip" if fmt == "srt"
             else "text/vtt") + "; charset=utf-8"
    return _send_raw(handler, buf.getvalue(), ctype)


def models_listing(state) -> dict:
    """GET /v1/models — the registry in OpenAI list form, plus the
    `whisper-1` alias every OpenAI client defaults to."""
    from . import models as model_registry
    data = [{"id": "whisper-1", "object": "model", "created": 0,
             "owned_by": "nobs-whisper-tpu"}]
    for m in model_registry.list_models():
        data.append({"id": m.id, "object": "model", "created": 0,
                     "owned_by": "nobs-whisper-tpu"})
    return {"object": "list", "data": data}


# ---- response plumbing ---------------------------------------------------

def _read_body(handler) -> bytes:
    # the serve.server Handler's own Content-Length reader
    return handler._body()


def _send(handler, obj: dict, code: int = 200) -> None:
    # OpenAI clients expect raw UTF-8 (ensure_ascii=False), which the
    # host handler's _json doesn't guarantee — keep the encoding here
    # but route through one response-plumbing path
    _send_raw(handler, json.dumps(obj, ensure_ascii=False),
              "application/json", code)


def _send_raw(handler, text: str, ctype: str, code: int = 200) -> None:
    body = text.encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
