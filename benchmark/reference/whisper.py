"""Plain Whisper in float32: the yardstick that decides ``correct``.

Written from the published model (openai/whisper ``model.py`` and
``audio.py``) and the published serving configuration, with no kernel,
cache or batching of the program under test, and importing nothing of it.
TF32 is off, so a float32 product is a float32 product.

* Mel: numpy float64 STFT (400-point periodic Hann, hop 160, reflect
  padding) of the request's audio followed by 30 s of silence, Slaney mel
  filters (librosa's formula), log10 with the 1e-10 floor, the clamp at
  the window's maximum less 8, then (x + 4) / 4: the first 3000 frames.
* Encoder: two convolutions with GELU, the sinusoid table, pre-LayerNorm
  blocks, the final LayerNorm. Under int8 serving every linear of a block
  quantizes its input per row (absmax / 127, rounded to nearest even) and
  multiplies the integers exactly (float64) by the weight's int8 values,
  scaled by both scales: the dynamic-int8 encoder.
* Decoder: token and position embeddings, causal self-attention,
  cross-attention over the encoder's states, GELU MLP, the final
  LayerNorm, logits against the token embedding. Under int8 serving the
  linear weights and the logit projection are int8 with per-output-channel
  scales (absmax / 127), dequantized to float32; activations stay float32.
* Quantization is redone here from the float weights the benchmark made.
  ``bits=4`` gives the control: the same model with int4 weights (absmax /
  7), everything else as above.

GELU is the exact (erf) one, as published; the program's bf16 encoder
uses the tanh form, a difference far below bf16's rounding.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_FRAMES, N_SAMPLES = 400, 160, 3000, 480000


# ---------------------------------------------------------------- mel ---

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    * 27.0 / np.log(6.4), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                               * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int, sr: int = 16000) -> np.ndarray:
    """librosa.filters.mel(sr, 400, n_mels) with Slaney scale and norm."""
    freqs = np.linspace(0, sr / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2),
                                n_mels + 2))
    fd = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None],
                                   ramps[2:] / fd[1:, None]))
    return w * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(audio: np.ndarray, n_mels: int) -> np.ndarray:
    """(n_mels, 3000) float32 log-mel of the first 30 s window."""
    x = np.concatenate([np.asarray(audio, np.float64)[:N_SAMPLES],
                        np.zeros(N_SAMPLES)])
    x = np.pad(x, (N_FFT // 2, N_FFT // 2), mode="reflect")
    idx = np.arange(N_FRAMES)[:, None] * HOP + np.arange(N_FFT)[None, :]
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    power = np.abs(np.fft.rfft(x[idx] * win, axis=1)) ** 2
    spec = np.log10(np.maximum(power @ mel_filters(n_mels).T, 1e-10))
    spec = np.maximum(spec, spec.max() - 8.0)
    return ((spec + 4.0) / 4.0).T.astype(np.float32)


# ---------------------------------------------------------- quantized ---

def quantize(w: torch.Tensor, bits: int):
    """Per-output-channel symmetric: (q float32 integers, s (1, N))."""
    top = float(2 ** (bits - 1) - 1)
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -top, top), s


def deq(w: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    if bits is None:
        return w.float()
    q, s = quantize(w, bits)
    return q * s


def dyn_linear(x: torch.Tensor, w: torch.Tensor, b, bits: int):
    """Dynamic-int8 linear: x's rows quantized to int8, exact integer sums."""
    sx = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(x / sx), -127, 127)
    q, s = quantize(w, bits)
    y = (xq.double() @ q.double()).float() * sx * s
    return y if b is None else y + b.float()


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), 1e-5)


def _attend(q, k, v, n_head, causal=False):
    """q (Tq, d), k/v (Tk, d) -> (Tq, d); batched over a leading axis."""
    *lead, tq, d = q.shape
    tk = k.shape[-2]
    dh = d // n_head
    sh = lambda z, t: z.reshape(*lead, t, n_head, dh).transpose(-2, -3)
    s = sh(q, tq) @ sh(k, tk).transpose(-1, -2) / math.sqrt(dh)
    if causal:
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool,
                                     device=q.device).triu(1), float("-inf"))
    a = torch.softmax(s, dim=-1) @ sh(v, tk)
    return a.transpose(-2, -3).reshape(*lead, tq, d)


# ------------------------------------------------------------- model ---

class Reference:
    """The plain model over the benchmark's weight tree ``tree`` (float
    leaves as made by ``benchmark/weights.py``) and model file ``c``.
    ``bits``: 8 for the int8 serving configuration (int8 weights and the
    dynamic-int8 encoder), 4 for its control, None for float weights."""

    def __init__(self, tree: Dict, c: dict, bits: Optional[int] = 8):
        self.t, self.c, self.bits = tree, c, bits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _lin(self, x, w, b, dyn: bool):
        if dyn:
            return dyn_linear(x, w, b, self.bits)
        y = x @ deq(w, self.bits)
        return y if b is None else y + b.float()

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, 3000) -> (B, 1500, d)."""
        e, c = self.t["encoder"], self.c
        w1, w2 = (e[k].float().permute(2, 1, 0) for k in ("conv1_w",
                                                          "conv2_w"))
        x = F.gelu(F.conv1d(mel.float(), w1, e["conv1_b"].float(), padding=1))
        x = F.gelu(F.conv1d(x, w2, e["conv2_b"].float(), stride=2,
                            padding=1))
        x = x.transpose(1, 2) + e["pos"].float()[: x.shape[-1]]
        dyn, h = self.bits is not None, c["encoder_attention_heads"]
        bl = e["blocks"]
        for i in range(c["encoder_layers"]):
            p = {k: v[i] for k, v in bl.items()}
            y = _ln(x, p["ln1_g"], p["ln1_b"])
            a = _attend(self._lin(y, p["q_w"], p["q_b"], dyn),
                        self._lin(y, p["k_w"], None, dyn),
                        self._lin(y, p["v_w"], p["v_b"], dyn), h)
            x = x + self._lin(a, p["o_w"], p["o_b"], dyn)
            y = _ln(x, p["ln2_g"], p["ln2_b"])
            y = F.gelu(self._lin(y, p["fc1_w"], p["fc1_b"], dyn))
            x = x + self._lin(y, p["fc2_w"], p["fc2_b"], dyn)
        return _ln(x, e["ln_post_g"], e["ln_post_b"])

    @torch.no_grad()
    def logits(self, xa: torch.Tensor, tokens) -> torch.Tensor:
        """Teacher-forced logits (S, V) of one row: ``xa`` (1500, d), the
        ``tokens`` (S,) at positions 0..S-1."""
        dcd, c = self.t["decoder"], self.c
        dev = xa.device
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        x = dcd["tok_emb"].float()[tok] + dcd["pos"].float()[: len(tok)]
        h, bl = c["decoder_attention_heads"], dcd["blocks"]
        for i in range(c["decoder_layers"]):
            p = {k: v[i] for k, v in bl.items()}
            lin = lambda z, w, b: self._lin(z, p[w], None if b is None
                                            else p[b], False)
            y = _ln(x, p["ln1_g"], p["ln1_b"])
            a = _attend(lin(y, "q_w", "q_b"), lin(y, "k_w", None),
                        lin(y, "v_w", "v_b"), h, causal=True)
            x = x + lin(a, "o_w", "o_b")
            y = _ln(x, p["lnx_g"], p["lnx_b"])
            a = _attend(lin(y, "xq_w", "xq_b"), lin(xa, "xk_w", None),
                        lin(xa, "xv_w", "xv_b"), h)
            x = x + lin(a, "xo_w", "xo_b")
            y = _ln(x, p["ln2_g"], p["ln2_b"])
            x = x + lin(F.gelu(lin(y, "fc1_w", "fc1_b")), "fc2_w", "fc2_b")
        x = _ln(x, dcd["ln_g"], dcd["ln_b"])
        return x @ deq(dcd["tok_emb"].t(), self.bits)
