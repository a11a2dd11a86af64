"""Uni-MoE-2.0-Omni's audio-to-text path: a Whisper encoder (the tower,
``models/whisper.py::encode``, its K13/K1/K2 kernels unchanged), a linear
connector, and a decoder-only language model whose FFN is a
dynamic-capacity mixture of experts (``ops/moe.py``).

Per layer: x += o(GQA attention(RoPE(q, k), v) of RMSNorm(x)); x +=
MoE(RMSNorm(x)); then a final RMSNorm and an untied head. The published
configuration and what it leaves open (the connector's pooling, the audio
positions, the router's rule, the prompt) are written out in the plain
reference, ``benchmark/reference/uni_moe.py``, which holds the same
choices.

The residual stream is f32 (Megatron's ``fp32_residual_connection``): each
block reads it through its RMSNorm in the compute dtype and adds its
output back in f32, so the rounding of 28 residual additions does not
move the router's gate, which is computed in f32 (``fp32_gate``).

Batches are left-padded: a row's tokens start at column ``pad_len``; its
RoPE position is the column less ``pad_len``, and pad columns are masked
as keys and take no expert. The prompt's ``<|audio_pad|>`` slots are
filled, in order, with the window's audio states. Prefill and decode share
:func:`lm_forward`; the head runs on each row's last prompt column at
prefill and on the step's token at decode. The KV cache is (layers, B, KV
heads, T, head_dim) in the compute dtype.

The window program (:func:`window_impl`) is Whisper's with the language
model in the decoder's place: frames -> mel -> tower -> connector ->
prefill -> the greedy loop of ``decode/greedy.py`` (its CUDA graph of one
step on the card), stopping at ``<|im_end|>`` or ``<|endoftext|>``. Each
forward writes every real token's chosen experts into a per-batch int8
tensor (layer, row, column, slot), by the step counter on the device, so
that the graph replays it; ``decode_window_finalize`` copies it to the
host with the tokens.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import UniMoEConfig
from ..ops.moe import moe_ffn

Params = Dict
_MASKED = -1e30
_WARMED = set()             # (device, rows): decode shapes built once


def init_params(seed: int, cfg: UniMoEConfig, dtype=torch.float32,
                device="cpu") -> Params:
    """Random weights (tests, ``chip_smoke.py``): the tower as
    ``models/whisper.py``'s, every matrix of the language model normal
    times fan_in ** -0.5 drawn on ``device`` (so a card makes the
    published widths' 52 GB itself), norms near 1, small biases, the gate
    in f32."""
    from .whisper import init_params as whisper_params
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, hd = cfg.d_model, cfg.head_dim

    def nrm(*shape, scale=None):
        s = shape[-2] ** -0.5 if scale is None else scale
        return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)

    def norm(n):
        return (1.0 + 0.05 * torch.randn(n, generator=g, device=dev)).to(
            dtype)

    layers = []
    for _ in range(cfg.n_layer):
        layers.append({
            "ln1": norm(d), "q_w": nrm(d, cfg.n_head * hd),
            "q_b": nrm(cfg.n_head * hd, scale=0.02),
            "k_w": nrm(d, cfg.n_kv_head * hd),
            "k_b": nrm(cfg.n_kv_head * hd, scale=0.02),
            "v_w": nrm(d, cfg.n_kv_head * hd),
            "v_b": nrm(cfg.n_kv_head * hd, scale=0.02),
            "o_w": nrm(cfg.n_head * hd, d), "ln2": norm(d),
            "gate": nrm(d, cfg.n_experts).float(),
            "w13": nrm(cfg.n_routed, d, 2 * cfg.expert_width),
            "w2": nrm(cfg.n_routed, cfg.expert_width, d),
            "s13": nrm(cfg.n_shared, d, 2 * cfg.shared_width),
            "s2": nrm(cfg.n_shared, cfg.shared_width, d)})
    tower = whisper_params(seed, cfg.tower, dtype=dtype, device=dev)
    return {"encoder": tower["encoder"],
            "connector": {"w": nrm(cfg.tower.n_audio_state, d),
                          "b": nrm(d, scale=0.02)},
            "embed": nrm(cfg.n_vocab, d, scale=1.0), "layers": layers,
            "norm": norm(d), "head": nrm(d, cfg.n_vocab)}


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float,
             dtype) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
            * g.float()).to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE of x (B, heads, S, hd) by (B, 1, S, hd) tables."""
    h = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([-xf[..., h:], xf[..., :h]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def connector(params: Params, xa: torch.Tensor, cfg: UniMoEConfig):
    """Tower states (B, T, 1280) -> (B, audio_tokens, d): adaptive average
    pooling over time, then the linear projector."""
    pooled = F.adaptive_avg_pool1d(xa.transpose(1, 2).float(),
                                   cfg.audio_tokens).transpose(1, 2)
    con = params["connector"]
    return pooled.to(con["w"].dtype) @ con["w"] + con["b"]


def init_cache(cfg: UniMoEConfig, b: int, t: int, dtype, device):
    shape = (cfg.n_layer, b, cfg.n_kv_head, t, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def lm_forward(params: Params, tokens: torch.Tensor,
               audio_states: Optional[torch.Tensor], cache_start,
               pad_lens: torch.Tensor, cache, cfg: UniMoEConfig,
               routing: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The language model over ``tokens`` (B, S) at cache columns
    [cache_start, cache_start + S): the prompt at prefill (``cache_start``
    0, ``audio_states`` (B, audio_tokens, d) filling its audio slots), one
    token at decode (``cache_start`` a 0-d long tensor on the device, the
    loop's step counter, which a CUDA graph reads at each replay). Writes
    the KV cache and, with ``routing`` (layers, B, T, top_k) int8, every
    real token's chosen experts (-1 for none) in place. Returns the logits
    (B, V) of each row's last column, in the compute dtype."""
    b, s = tokens.shape
    dev = tokens.device
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.n_head, cfg.n_kv_head
    dt = params["embed"].dtype
    x = params["embed"][tokens].float()
    if audio_states is not None:
        slot = tokens == cfg.audio_pad
        idx = torch.clamp(torch.cumsum(slot, 1) - 1, 0,
                          audio_states.shape[1] - 1)
        x = torch.where(slot[..., None], torch.gather(
            audio_states.float(), 1, idx[..., None].expand(b, s, d)), x)
    cols = cache_start + torch.arange(s, device=dev)                  # (S,)
    pos = torch.clamp(cols[None, :] - pad_lens[:, None], min=0)       # (B, S)
    inv = 1.0 / cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=dev) / hd)
    ang = pos[..., None].float() * inv          # (B, S, hd / 2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    real = (cols[None, :] >= pad_lens[:, None]).reshape(-1)
    prefill = isinstance(cache_start, int)
    ck, cv = cache
    t_keys = s if prefill else ck.shape[3]
    keys = torch.arange(t_keys, device=dev)
    mask = ((keys[None, None, :] <= cols[None, :, None])
            & (keys[None, None, :] >= pad_lens[:, None, None]))
    # a KV head's query heads' rows stacked: (B, 1, heads/KV x S, T)
    g = h // kv
    mask = mask[:, None, None].expand(b, 1, g, s, t_keys).reshape(
        b, 1, g * s, t_keys)
    for i, p in enumerate(params["layers"]):
        y = rms_norm(x, p["ln1"], cfg.rms_eps, dt)
        q = (y @ p["q_w"] + p["q_b"]).view(b, s, h, hd).transpose(1, 2)
        k = (y @ p["k_w"] + p["k_b"]).view(b, s, kv, hd).transpose(1, 2)
        v = (y @ p["v_w"] + p["v_b"]).view(b, s, kv, hd).transpose(1, 2)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        if prefill:
            ck[i, :, :, cache_start:cache_start + s] = k
            cv[i, :, :, cache_start:cache_start + s] = v
        else:
            ck[i].index_copy_(2, cols, k)
            cv[i].index_copy_(2, cols, v)
            k, v = ck[i], cv[i]
        # scores and PV in the compute dtype with f32 sums, the softmax in
        # f32 (Qwen2's eager attention), each KV head's query heads as rows
        sc = q.reshape(b, kv, g * s, hd) @ k.transpose(-1, -2)
        pr = torch.softmax((sc.float() * hd ** -0.5).masked_fill(
            ~mask, _MASKED), -1).to(dt)
        a = (pr @ v).view(b, h, s, hd).transpose(1, 2)
        x = x + (a.reshape(b, s, h * hd) @ p["o_w"]).float()
        y = rms_norm(x, p["ln2"], cfg.rms_eps, dt)
        out, ids = moe_ffn(y.reshape(b * s, d), p, cfg, real)
        x = x + out.view(b, s, d)
        if routing is not None:
            ids = ids.view(b, s, -1).to(torch.int8)
            if prefill:
                routing[i, :, cache_start:cache_start + s] = ids
            else:
                routing[i].index_copy_(1, cols, ids)
    last = rms_norm(x[:, -1], params["norm"], cfg.rms_eps, dt)
    return last @ params["head"]


@torch.inference_mode()
def window_impl(params: Params, frames: torch.Tensor,
                prompt_tokens: torch.Tensor, pad_lens: torch.Tensor,
                cfg: UniMoEConfig, sample_len: int,
                compute_dtype=torch.bfloat16, cuda_graph: bool = True):
    """STFT-framed audio -> mel -> tower -> connector -> prefill -> greedy
    steps. Returns (tokens (B, sample_len), n_sampled (B,), sum_logprob
    (B,), no_speech_prob (B,) zeros, routing (layers, B, T, top_k) int8),
    device tensors. On a CUDA device with ``cuda_graph`` the steps replay
    one captured step (``decode/greedy.py::_StepGraph``)."""
    from ..audio.mel import log_mel_from_frames
    from ..decode.greedy import _StopLoop, run_steps
    from ..utils.profiling import batch_record
    from .whisper import encode
    rec, t = batch_record(), time.time_ns()
    tw = cfg.tower
    mel = log_mel_from_frames(frames, n_mels=tw.n_mels,
                              n_frames=2 * tw.n_audio_ctx)
    audio = connector(params, encode(params, mel, tw, compute_dtype), cfg)
    t = rec.add("encode", t)
    b, p_max = prompt_tokens.shape
    dev = frames.device
    t_cache = -(-(p_max + sample_len) // 8) * 8
    cache = init_cache(cfg, b, t_cache, compute_dtype, dev)
    routing = torch.full((cfg.n_layer, b, t_cache, cfg.top_k), -1,
                         dtype=torch.int8, device=dev)

    def forward(tokens, cache_start):
        return lm_forward(params, tokens, None, cache_start, pad_lens,
                          cache, cfg, routing)[:, None].float()

    logits = lm_forward(params, prompt_tokens, audio, 0, pad_lens, cache,
                        cfg, routing).float()
    loop = _StopLoop(logits, cfg.eot, cfg.stop_ids, sample_len, p_max,
                     forward)
    use_graph = cuda_graph and dev.type == "cuda"
    if use_graph and (dev, b) not in _WARMED and sample_len > 1:
        # a decode shape's kernels are built before their first capture:
        # one step's forward on the cache column step 0 writes again
        forward(prompt_tokens[:, -1:], loop.step + p_max)
        _WARMED.add((dev, b))
    t = rec.add("prefill", t)
    run_steps(loop, sample_len, use_graph, dev, rec, t)
    stop = torch.tensor(cfg.stop_ids, device=dev)
    n_sampled = torch.sum(~torch.isin(loop.tokens, stop), dim=1)
    return (loop.tokens, n_sampled, loop.sum_logprob,
            torch.zeros(b, dtype=torch.float32, device=dev), routing)


def window_dispatch(params: Params, prompts, cfg: UniMoEConfig, opts,
                    temperature=0.0, compute_dtype=torch.bfloat16,
                    frames: Optional[torch.Tensor] = None, other=None,
                    speculative: int = 0, mesh=None):
    """``decode/greedy.py::decode_window_dispatch`` for this model: pad the
    prompts, run :func:`window_impl`; the handle carries the batch's
    routing (``utils/profiling.py::RoutingTrace``). Only framed
    windows decoded greedily on one device are served: a mel or encoder
    states (``other``), sampling, speculative decoding and a mesh raise
    ValueError."""
    from ..decode.greedy import WindowHandle, pad_prompts
    from ..utils.profiling import RoutingTrace, batch_record
    t = time.time_ns()
    n = len(prompts)
    temps = np.broadcast_to(np.asarray(temperature, np.float32),
                            (n,)).copy()
    refused = [what for what, on in (
        ("a mel or encoder states (frames only)", frames is None
         or other is not None),
        ("temperature sampling", bool(np.any(temps > 0))),
        ("speculative decoding", bool(speculative or opts.speculative)),
        ("a mesh", mesh is not None)) if on]
    if refused:
        raise ValueError(f"{cfg.name} is not served with "
                         + ", ".join(refused))
    dev = frames.device
    prompt_np, pad_np = pad_prompts(prompts, cfg.eot)
    p_max = prompt_np.shape[1]
    sample_len = min(opts.sample_len or 128, cfg.n_ctx - p_max)
    rec = batch_record()
    t = rec.add("prefill", t)
    out = window_impl(params, frames,
                      torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
                      torch.as_tensor(pad_np, dtype=torch.long, device=dev),
                      cfg, sample_len, compute_dtype)
    return WindowHandle(*out[:4], temps, routing=RoutingTrace(
        out[4], pad_np, p_max, cfg.n_routed, cfg.n_experts))


class WindowProgram:
    """This model's window program for ``pipeline/batcher.py::
    WindowBatcher`` (``decode/greedy.py::WindowProgram``'s surface): no
    logit rules (the loop is plain greedy to the stop ids) and
    :func:`window_dispatch`."""

    @staticmethod
    def rule_tables(cfg, opts, tokenizer, device):
        return None

    @staticmethod
    def dispatch(params, xa, prompts, cfg, tables, opts, temperature=0.0,
                 generator=None, compute_dtype=torch.bfloat16, mel=None,
                 frames=None, speculative: int = 0, draft_pool: int = 4,
                 draft=None, mesh=None):
        return window_dispatch(
            params, prompts, cfg, opts, temperature, compute_dtype,
            frames=frames, other=xa if mel is None else mel,
            speculative=speculative, mesh=mesh)


UNIMOE_WINDOW = WindowProgram()
