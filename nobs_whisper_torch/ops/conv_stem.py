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

The CUDA kernels live in ``csrc/conv_stem.cu`` (a mel pass, then conv1
and conv2 on ``wgmma`` fed by TMA); its source note says what bounds them
on an H100 and how the design answers that. :func:`encoder_stem_fused`
launches them for a CUDA tensor (or raises) and runs
:func:`encoder_stem_fused_plain` for a CPU tensor; ``launch_count``
counts calls of the C entry only. :func:`stem_reference` is the unfused
stem.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .fused_mlp import gelu_tanh

launch_count = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"nwt_encoder_stem": [_P] * 5 + [_I] + [_P] * 4 + [_I] * 5 + [_P]}
# the mel rows' channel quantum (csrc/conv_stem.cu MEL_CQ): the kernel's
# (B, n_frames, C) bf16 copy of the mel has C rounded up to it
MEL_CQ = 8


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
    d a multiple of 128 (the reference's asserts). On the card the kernel
    reads bf16 weights and pos and f32 or bf16 biases as they lie (the
    serving engine's bf16 parameters: no copy, no launch besides the
    kernels'); other types are converted first."""
    global launch_count
    _build.no_autograd("K13", mel, w1, b1, w2, b2, pos)
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
            or b1.numel() != d or b2.numel() != d or pos.dim() != 2 \
            or pos.shape[0] < t_half or pos.shape[1] != d:
        raise ValueError(f"K13: w1 (3, C_in, d), w2 (3, d, d), (d,) biases "
                         f"and at least n_frames // 2 pos rows of d; got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(b1.shape)}, {tuple(b2.shape)}, "
                         f"{tuple(pos.shape)}")
    fn = _build.load("conv_stem", _SIG).nwt_encoder_stem
    dev, bf = mel.device, torch.bfloat16
    if any(z.device != dev for z in (w1, b1, w2, b2, pos)):
        raise ValueError("K13: every operand on the mel's device")
    # The kernel reads the f32 mel, the weights as stored in bf16 and the
    # biases in f32 or bf16; anything else is converted here. Each converted
    # tensor is held in a name until the launch: a temporary's memory could
    # be handed to the next temporary before the kernel reads it.
    melf = _operand(mel, torch.float32)
    w1b, w2b = _operand(w1, bf), _operand(w2, bf)
    bias_dt = b1.dtype if b1.dtype == b2.dtype and b1.dtype in (
        torch.float32, bf) else torch.float32
    b1c, b2c = _operand(b1, bias_dt), _operand(b2, bias_dt)
    posb = _operand(pos, bf)             # rows < n_frames // 2 are read
    # one workspace: the kernel's bf16 copy of the mel, (B, n_frames, C_in
    # rounded up to MEL_CQ), then conv1's output (B, n_frames, d)
    x_len = b * n_frames * (-(-c_in // MEL_CQ) * MEL_CQ)
    ws = torch.empty(x_len + b * n_frames * d, dtype=bf, device=dev)
    out = torch.empty((b, t_out_pad, d), dtype=bf, device=dev)
    # the raw stream query: torch.cuda.current_stream() costs ~5 us a call
    err = fn(melf.data_ptr(), w1b.data_ptr(), b1c.data_ptr(),
             w2b.data_ptr(), b2c.data_ptr(), int(bias_dt == torch.float32),
             posb.data_ptr(), ws.data_ptr(), ws.data_ptr() + 2 * x_len,
             out.data_ptr(), b, n_frames, c_in, d, t_out_pad,
             torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "encoder_stem_fused")
    with _build.COUNT_LOCK:
        launch_count += 1
    return out


def _operand(z: torch.Tensor, dtype) -> torch.Tensor:
    """``z`` as the kernel reads it: ``dtype``, contiguous, 16-byte
    aligned (the tensor maps' base address); ``z`` itself when it is."""
    if z.dtype != dtype or not z.is_contiguous():
        z = z.to(dtype).contiguous()
    return z if z.data_ptr() % 16 == 0 else z.clone()
