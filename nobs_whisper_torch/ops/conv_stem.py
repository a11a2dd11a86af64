"""K13: the encoder's conv stem in one kernel call under ``NWT_STEM_FUSED``
(port of ``ops/conv_stem.py``): conv1 (k3, s1) -> gelu -> conv2 (k3, s2)
-> gelu -> + pos, the output padded with zero rows to the encoder's T.

Numeric contract (the TPU kernel's, conv_stem.py:27-33, :92-115): mel rows
and weights in bf16, f32 sums; each conv sum plus bias rounded to bf16,
then the tanh gelu with f32 internals, then rounded to bf16; pos added in
bf16; rows >= t_real exact zeros. The unfused bf16 stem
(``models/whisper.py::_gelu_fast``) rounds every gelu operation to bf16
instead, one bf16 step apart on ~40% of elements: both are valid bf16
roundings, and the plain version here follows the kernel.

The CUDA kernel lives in ``csrc/conv_stem.cu``; its source note says what
bounds it on an H100 and how the design answers that.
:func:`encoder_stem_fused` launches it for a CUDA tensor (or raises) and
runs :func:`encoder_stem_fused_plain` for a CPU tensor; ``launch_count``
counts kernel launches only. :func:`stem_reference` is the unfused stem.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .fused_mlp import gelu_tanh

launch_count = 0

_SIG = {"nwt_encoder_stem": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]}


def _round_gelu(s: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ``round_gelu``: f32 sum -> bf16 -> tanh gelu in
    f32 -> bf16 (returned as f32 values)."""
    return gelu_tanh(s.to(torch.bfloat16).float()).to(torch.bfloat16).float()


def _conv_k3(x, w, b, stride: int):
    """sum_j x[stride r + j - 1] @ w[j] + b in f32, rows outside the input
    zero. x: (B, n, C) f32 holding bf16 values; w: (3, C, d)."""
    n_out = x.shape[1] // stride
    xp = F.pad(x, (0, 0, 1, 1))
    w = w.to(torch.bfloat16).float()
    taps = [xp[:, j:j + stride * n_out:stride] @ w[j] for j in range(3)]
    return taps[0] + taps[1] + taps[2] + b.float()


def encoder_stem_fused_plain(mel, w1, b1, w2, b2, pos,
                             t_out_pad: int) -> torch.Tensor:
    """Plain PyTorch K13 with the Pallas kernel's numerics.
    (B, t_out_pad, d) bf16."""
    t_half = mel.shape[-1] // 2
    x = mel.transpose(-1, -2).to(torch.bfloat16).float()    # (B, F, C)
    a = _round_gelu(_conv_k3(x, w1, b1, 1))
    y = _round_gelu(_conv_k3(a, w2, b2, 2)).to(torch.bfloat16)
    y = y + pos[:t_half].to(torch.bfloat16)                   # bf16 add
    return F.pad(y, (0, 0, 0, t_out_pad - t_half))


def stem_reference(mel, w1, b1, w2, b2, pos):
    """The unfused bf16 stem (``models/whisper.py::_encode``, tanh-gelu
    serving variant), for comparisons."""
    from ..models.whisper import _conv1d, _gelu_fast
    x = mel.transpose(-1, -2).to(torch.bfloat16)
    x = _gelu_fast(_conv1d(x, w1, b1, stride=1))
    x = _gelu_fast(_conv1d(x, w2, b2, stride=2))
    return x + pos[:x.shape[1]].to(torch.bfloat16)


def encoder_stem_fused(mel, w1, b1, w2, b2, pos,
                       t_out_pad: int) -> torch.Tensor:
    """K13. ``mel``: (B, C_in, n_frames) f32, n_frames even; ``w1``:
    (3, C_in, d); ``w2``: (3, d, d); ``b1``/``b2``: (d,); ``pos``: at
    least (n_frames // 2, d). Returns (B, t_out_pad, d) bf16, rows past
    n_frames // 2 zero; ``t_out_pad`` >= n_frames // 2, a multiple of 8,
    d a multiple of 128 (the reference's asserts)."""
    global launch_count
    b, c_in, n_frames = mel.shape
    d = w1.shape[-1]
    t_half = n_frames // 2
    assert n_frames % 2 == 0 and t_out_pad >= t_half, (n_frames, t_out_pad)
    assert t_out_pad % 8 == 0 and d % 128 == 0, (t_out_pad, d)
    if mel.device.type == "cpu":
        return encoder_stem_fused_plain(mel, w1, b1, w2, b2, pos, t_out_pad)
    if mel.device.type != "cuda":
        raise ValueError(f"unsupported device {mel.device}")
    if tuple(w1.shape) != (3, c_in, d) or tuple(w2.shape) != (3, d, d) \
            or pos.shape[0] < t_half:
        raise ValueError(f"K13: w1 (3, C_in, d), w2 (3, d, d) and at least "
                         f"n_frames // 2 pos rows; got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(pos.shape)}")
    from . import _build
    lib = _build.load("conv_stem", _SIG)
    dev = mel.device
    bf = torch.bfloat16
    c = -(-c_in // 32) * 32              # zero channels up to the K slab
    x = F.pad(mel.transpose(1, 2).to(bf), (0, c - c_in)).contiguous()
    # weights n-major: wt[n, j C + c] = w[j, c, n]
    w1t = F.pad(w1.to(bf), (0, 0, 0, c - c_in)).permute(2, 0, 1).reshape(
        d, 3 * c).contiguous()
    w2t = w2.to(bf).permute(2, 0, 1).reshape(d, 3 * d).contiguous()
    # held in names until the launch: a temporary's memory could be handed
    # to the next temporary before the kernel reads it
    b1f, b2f = (z.to(device=dev, dtype=torch.float32).contiguous()
                for z in (b1, b2))
    posb = pos[:t_half].to(device=dev, dtype=bf).contiguous()
    a = torch.empty((b, n_frames, d), dtype=bf, device=dev)
    out = torch.empty((b, t_out_pad, d), dtype=bf, device=dev)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = lib.nwt_encoder_stem(
        ptr(x), ptr(w1t), ptr(b1f), ptr(w2t), ptr(b2f), ptr(posb),
        ptr(a), ptr(out), b, n_frames, c, d, t_out_pad,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "encoder_stem_fused")
    launch_count += 1
    return out
