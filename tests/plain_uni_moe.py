"""Plain Uni-MoE-2.0-Omni audio-to-text in float32: the yardstick that
decides ``correct`` for the ``uni_moe`` family.

Written from the published configuration
(HIT-TMG/Uni-MoE-2.0-Omni ``config.json``: 28 layers of d 3584, GQA with 28
query and 4 KV heads of 128, RMSNorm eps 1e-6, RoPE theta 1e6, no sliding
window; a dynamic-capacity MoE FFN in every layer: 4 routed SwiGLU experts
of 18,944, 1 null expert, top-p 0.7 capped at 2, an f32 gate, 2 shared
experts of 2,368; an untied head over 152,064 ids) and openai/whisper's
``model.py`` and ``audio.py`` for the tower. It has no kernel, cache or
batching, imports nothing but torch and numpy, and sets TF32 off, so a
float32 product is a float32 product. It runs one layer at a time over
all the rows it is given, the layer's weights asked for by index
(``layer(i)``), so that it never holds more than one float32 layer.

Not given by the configuration, assumed here and in the program alike:

1. The tower is Whisper-large-v3's encoder (32 layers, 20 heads, 128 mels,
   1500 positions) under the program's int8 serving: every linear of a
   block quantizes its input per row (absmax / 127, rounded to nearest
   even) and multiplies the integers exactly (float64) by the weight's
   int8 per-output-channel values. Its 1500 states are average-pooled
   into ``whisper_query_tokens_size`` (200) bins as adaptive pooling
   defines them (bin i covers frames floor(7.5 i) to ceil(7.5 (i + 1)),
   8 frames, neighbours sharing one where 7.5 i is not whole), then the
   linear projector maps 1280 -> 3584 with a bias. ``whisper_audio_time``
   is not used.
2. Audio tokens take consecutive 1-D positions like text; with equal
   t/h/w ids M-RoPE (``mrope_section``) is plain RoPE, rotate-half.
3. The router: p = softmax of the f32 gate's logits over the 4 routed and
   the null expert; p sorted descending, a token takes the shortest
   prefix whose sum reaches 0.7, at most 2. A routed expert chosen adds
   its output times its own p (no renormalisation); a null chosen adds 0.
   The shared experts are summed unweighted.
4. q, k and v have biases and o has none (Qwen2's attention).
5. The prompt (:func:`prompt_ids`), a Qwen2-style chat whose turns'
   newlines are left out: ``<|im_start|>`` system text ``<|im_end|>``
   ``<|im_start|>`` user ``<|audio_start|>``, 200 ``<|audio_pad|>``,
   ``<|audio_end|>``, the instruction and the request's vocabulary and
   context text, ``<|im_end|>`` ``<|im_start|>`` assistant. The special ids
   follow ``endoftext`` (151,643): ``im_start``, ``im_end``,
   ``audio_start``, ``audio_end``, ``audio_pad``.

Routing is discontinuous, so :meth:`Reference.run` routes each token of
each layer itself, from its own hidden state, and reports each decision's
margin to its nearest boundary (the 0.7 line for the first probability,
and the gap that decides which expert fills a chosen slot); with the
program's decisions handed in, it applies those to compute its logits.

The tower's GELU is the exact (erf) one, as published; the program's bf16
tower uses the tanh form, a difference far below bf16's rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_FRAMES, N_SAMPLES = 400, 160, 3000, 480000
SYSTEM = " system you are a helpful assistant"
USER = " user"
INSTRUCTION = " transcribe the audio"
ASSISTANT = " assistant"


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


# ------------------------------------------------------------- prompt ---

def special_ids(c: dict) -> Dict[str, int]:
    e = c["endoftext"]
    return {"endoftext": e, "im_start": e + 1, "im_end": e + 2,
            "audio_start": e + 3, "audio_end": e + 4, "audio_pad": e + 5}


def prompt_ids(encode: Callable[[str], List[int]], c: dict,
               vocabulary: str, context: str) -> List[int]:
    """The window's prompt (assumption 5); ``encode`` maps text to ids."""
    s = special_ids(c)
    parts = [p.strip() for p in (vocabulary, context) if p and p.strip()]
    extra = encode(" " + " ".join(parts)) if parts else []
    return ([s["im_start"], *encode(SYSTEM), s["im_end"], s["im_start"],
             *encode(USER), s["audio_start"]]
            + [s["audio_pad"]] * c["whisper_query_tokens_size"]
            + [s["audio_end"], *encode(INSTRUCTION), *extra, s["im_end"],
               s["im_start"], *encode(ASSISTANT)])


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


def dyn_linear(x: torch.Tensor, w: torch.Tensor, b):
    """Dynamic-int8 linear: x's rows quantized to int8, exact integer sums."""
    sx = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(x / sx), -127, 127)
    q, s = quantize(w, 8)
    y = (xq.double() @ q.double()).float() * sx * s
    return y if b is None else y + b.float()


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), 1e-5)


def _attend(q, k, v, n_head):
    """Full attention, q/k/v (..., T, d) -> (..., T, d)."""
    *lead, t, d = q.shape
    dh = d // n_head
    sh = lambda z: z.reshape(*lead, t, n_head, dh).transpose(-2, -3)
    s = sh(q) @ sh(k).transpose(-1, -2) / math.sqrt(dh)
    a = torch.softmax(s, dim=-1) @ sh(v)
    return a.transpose(-2, -3).reshape(*lead, t, d)


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _rope(x, theta):
    """x (H, S, hd) at positions 0..S-1, rotate-half."""
    hd, s = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def route(p: torch.Tensor, top_p: float, top_k: int):
    """p (S, E) -> (ids (S, top_k) long, -1 for a slot not taken, sorted
    by p; margin (S,): the distance to the nearest boundary of the
    decision: p1 to ``top_p``, and the gap that decides the expert of the
    last slot taken (p1 - p2 with one taken, p2 - p3 with two))."""
    ps, order = torch.sort(p, dim=-1, descending=True)
    before = torch.cat([torch.zeros_like(ps[:, :1]),
                        torch.cumsum(ps, -1)[:, :-1]], -1)
    take = (before < top_p)[:, :top_k]
    ids = torch.where(take, order[:, :top_k], -1)
    n = take.sum(-1)
    last = torch.gather(ps, 1, (n - 1)[:, None])[:, 0]
    nxt = torch.gather(ps, 1, n[:, None])[:, 0]
    margin = torch.minimum((ps[:, 0] - top_p).abs(), last - nxt)
    return ids, margin


# ------------------------------------------------------------- model ---

class Reference:
    """The plain model over ``tree`` (``encoder``: Whisper's stacked
    encoder leaves; ``connector`` ``w`` (1280, d) and ``b``; ``embed``
    (V, d); ``norm``; ``head`` (d, V)) and ``layer(i)``, layer i's weights
    (``ln1``, ``q_w``, ``q_b``, ``k_w``, ``k_b``, ``v_w``, ``v_b``,
    ``o_w``, ``ln2``, ``gate`` (d, routed + null), ``w13`` (R, d, 2F: gate
    then up), ``w2`` (R, F, d), ``s13``, ``s2`` the shared experts'), for
    the model file ``c`` (the catalog's keys and ``tower``). ``bits``
    (None, 8 or 4): the language model's matrices at that many bits per
    output channel (the control), the tower at int8 throughout."""

    def __init__(self, tree: Dict, c: dict,
                 layer: Callable[[int], Dict], bits: Optional[int] = None):
        self.t, self.c, self.layer, self.bits = tree, c, layer, bits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, 3000) -> (B, 1500, 1280) under int8 serving."""
        e, c = self.t["encoder"], self.c["tower"]
        w1, w2 = (e[k].float().permute(2, 1, 0) for k in ("conv1_w",
                                                          "conv2_w"))
        x = F.gelu(F.conv1d(mel.float(), w1, e["conv1_b"].float(), padding=1))
        x = F.gelu(F.conv1d(x, w2, e["conv2_b"].float(), stride=2,
                            padding=1))
        x = x.transpose(1, 2) + e["pos"].float()[: x.shape[-1]]
        bl = e["blocks"]
        for i in range(c["encoder_layers"]):
            p = {k: v[i] for k, v in bl.items()}
            y = _ln(x, p["ln1_g"], p["ln1_b"])
            a = _attend(dyn_linear(y, p["q_w"], p["q_b"]),
                        dyn_linear(y, p["k_w"], None),
                        dyn_linear(y, p["v_w"], p["v_b"]),
                        c["encoder_attention_heads"])
            x = x + dyn_linear(a, p["o_w"], p["o_b"])
            y = _ln(x, p["ln2_g"], p["ln2_b"])
            y = F.gelu(dyn_linear(y, p["fc1_w"], p["fc1_b"]))
            x = x + dyn_linear(y, p["fc2_w"], p["fc2_b"])
        return _ln(x, e["ln_post_g"], e["ln_post_b"])

    @torch.no_grad()
    def audio(self, xa: torch.Tensor) -> torch.Tensor:
        """(B, 1500, 1280) -> (B, 200, d): adaptive average pooling, then
        the linear projector."""
        n, t = self.c["whisper_query_tokens_size"], xa.shape[1]
        bins = [xa[:, (i * t) // n: -(-((i + 1) * t) // n)].mean(1)
                for i in range(n)]
        con = self.t["connector"]
        return torch.stack(bins, 1).float() @ con["w"].float() \
            + con["b"].float()

    @torch.no_grad()
    def run(self, rows: List[dict]) -> List[dict]:
        """Teacher-forced rows, all at once a layer at a time. A row:
        ``tokens`` (S,) ids, ``audio`` (200, d) its audio states, ``lo``
        the first position whose logits are wanted, ``decisions`` None
        (route itself) or (layers, S, top_k) ids to apply. Returns per
        row ``logits`` (S - lo, V) f32 (on the device), ``ids`` (layers,
        S, top_k) the reference's own decisions and ``margin`` (layers,
        S) their margins."""
        c, bits = self.c, self.bits
        d, hd = c["hidden_size"], c["hidden_size"] // c["num_attention_heads"]
        h, kv = c["num_attention_heads"], c["num_key_value_heads"]
        nr, eps = c["mlp_dynamic_expert_num"], c["rms_norm_eps"]
        top_p, top_k = c["mlp_dynamic_top_p"], c["mlp_dynamic_top_k"]
        pad = special_ids(c)["audio_pad"]
        xs, out = [], []
        for r in rows:
            tok = torch.as_tensor(np.asarray(r["tokens"]), dtype=torch.long,
                                  device=r["audio"].device)
            x = self.t["embed"][tok].float()
            slots = (tok == pad).nonzero()[:, 0]
            x[slots] = r["audio"].float()[: slots.numel()]
            xs.append(x)
            out.append({"ids": [], "margin": []})
        for i in range(c["num_hidden_layers"]):
            p = self.layer(i)
            lin = {k: deq(p[k], bits) for k in ("q_w", "k_w", "v_w", "o_w",
                                                "gate")}
            w13, w2 = deq(p["w13"], bits), deq(p["w2"], bits)
            s13, s2 = deq(p["s13"], bits), deq(p["s2"], bits)
            f, fs = w2.shape[1], s2.shape[1]
            for j, r in enumerate(rows):
                x = xs[j]
                s = x.shape[0]
                y = _rms(x, p["ln1"], eps)
                q = (y @ lin["q_w"] + p["q_b"].float()).view(s, h, hd)
                k = (y @ lin["k_w"] + p["k_b"].float()).view(s, kv, hd)
                v = (y @ lin["v_w"] + p["v_b"].float()).view(s, kv, hd)
                q = _rope(q.transpose(0, 1), c["rope_theta"])
                k = _rope(k.transpose(0, 1), c["rope_theta"])
                k = k.repeat_interleave(h // kv, 0)
                v = v.transpose(0, 1).repeat_interleave(h // kv, 0)
                sc = q @ k.transpose(-1, -2) / math.sqrt(hd)
                sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                               device=x.device).triu(1),
                                    float("-inf"))
                a = (torch.softmax(sc, -1) @ v).transpose(0, 1).reshape(s, -1)
                x = x + a @ lin["o_w"]
                y = _rms(x, p["ln2"], eps)
                prob = torch.softmax(y @ lin["gate"], -1)
                own, margin = route(prob, top_p, top_k)
                out[j]["ids"].append(own)
                out[j]["margin"].append(margin)
                use = own if r.get("decisions") is None else torch.as_tensor(
                    np.asarray(r["decisions"][i]), dtype=torch.long,
                    device=x.device)
                ffn = torch.zeros_like(x)
                for e in range(nr):
                    at = (use == e).any(-1).nonzero()[:, 0]
                    if at.numel():
                        z = y[at]
                        hh = F.silu(z @ w13[e, :, :f]) * (z @ w13[e, :, f:])
                        ffn[at] += (hh @ w2[e]) * prob[at, e, None]
                for e in range(s13.shape[0]):
                    hh = F.silu(y @ s13[e, :, :fs]) * (y @ s13[e, :, fs:])
                    ffn += hh @ s2[e]
                xs[j] = x + ffn
            del p, lin, w13, w2, s13, s2
        head = deq(self.t["head"], bits)
        for j, r in enumerate(rows):
            x = _rms(xs[j][r["lo"]:], self.t["norm"], eps)
            out[j]["logits"] = x @ head
            out[j]["ids"] = torch.stack(out[j]["ids"]).cpu().numpy()
            out[j]["margin"] = torch.stack(out[j]["margin"]).cpu().numpy()
        return out
