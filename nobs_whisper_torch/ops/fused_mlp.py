"""K2 and K8: fused LN + int8 fc1 + tanh gelu + requant + int8 fc2 +
residual.

Ports of ``ops/fused_mlp.py``'s two encoder MLP kernels (whisper.py:528-554):

* K2 :func:`encoder_mlp_int8_resident` (``encoder_mlp_int8_resident``), the
  quantized encoder's default, block_f 2560;
* K8 :func:`encoder_mlp_int8` (``encoder_mlp_int8``), taken under
  ``NWT_MLP_CHUNKED``, block_f 1280.

The TPU kernels compute one function and differ in what stays in VMEM; the
function's one parameter is ``block_f``, the width of the chunks in which
fc2's input is re-quantized. Both CUDA entry points live in
``csrc/fused_mlp.cu`` on the same templated kernels; its source note says
what bounds them on an H100 and how the design answers that.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its ``*_plain`` version for a CPU tensor. ``launch_count`` (K2) and
``k8_launch_count`` count kernel launches only, of both activation types:
bf16, and f32 for the int8 encoder at f32 compute (the reference's gates
test no dtype); ``launch_count_f32`` and ``k8_launch_count_f32`` count the
f32 launches alone.
"""

from __future__ import annotations

import ctypes

import torch

from .quant import int8_matmul_exact, ln_f32, quantize_rows

launch_count = 0
launch_count_f32 = 0
k8_launch_count = 0
k8_launch_count_f32 = 0

_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY = {("K2", torch.bfloat16): "nwt_encoder_mlp_int8",
          ("K2", torch.float32): "nwt_encoder_mlp_int8_f32",
          ("K8", torch.bfloat16): "nwt_encoder_mlp_int8_chunked",
          ("K8", torch.float32): "nwt_encoder_mlp_int8_chunked_f32"}
_SIG = {fn: _ARGS for fn in _ENTRY.values()}


def resolve_block_f(block_f: int, ffn: int) -> int:
    """The FFN chunk width exactly as the reference resolves it
    (fused_mlp.py:284-289): the fc2 input is re-quantized per chunk."""
    block_f = min(block_f, ffn)
    while ffn % block_f or block_f % 128:
        block_f -= 128
        if block_f <= 0:
            block_f = ffn
            break
    return block_f


def gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    """The kernels' tanh gelu, in the reference's operation order."""
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * a * (1.0 + torch.tanh(c * (a + 0.044715 * a * a * a)))


def mlp_int8_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b,
                    block_f: int) -> torch.Tensor:
    """The Pallas kernels' function (``_enc_mlp_kernel``,
    ``_enc_mlp_res_kernel``) in plain PyTorch, shared by K2's, K8's and
    K12's plain versions. x: (M, d)."""
    m, d = x.shape
    ffn = fc1["q"].shape[-1]
    block_f = resolve_block_f(block_f, ffn)
    xf = x.to(torch.float32)
    xq, sx = quantize_rows(ln_f32(x, ln_g, ln_b))
    acc = xf + fc2_b.to(torch.float32)
    w1s = fc1["s"].reshape(1, ffn).to(torch.float32)
    b1 = fc1_b.reshape(1, ffn).to(torch.float32)
    w2s = fc2["s"].reshape(1, d).to(torch.float32)
    for j in range(ffn // block_f):
        sl = slice(j * block_f, (j + 1) * block_f)
        h1 = int8_matmul_exact(xq, fc1["q"][:, sl])
        a = gelu_tanh(h1 * sx * w1s[:, sl] + b1[:, sl])
        aq, sa = quantize_rows(a)
        acc = acc + int8_matmul_exact(aq, fc2["q"][sl, :]) * sa * w2s
    return acc.to(x.dtype)


def encoder_mlp_int8_resident_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b,
                                    block_f: int = 640) -> torch.Tensor:
    """Plain PyTorch K2 with the Pallas kernel's numerics. x: (M, d)."""
    return mlp_int8_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f)


def encoder_mlp_int8_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b,
                           block_f: int = 640) -> torch.Tensor:
    """Plain PyTorch K8 with the Pallas kernel's numerics: K2's function
    at the given ``block_f``. x: (M, d)."""
    return mlp_int8_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f)


def encoder_mlp_int8_resident(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b,
                              block_f: int = 640) -> torch.Tensor:
    """K2: x + fc2(requant(gelu_tanh(fc1(quant(LN x))))) with int8 weights.

    ``x``: (M, d) bf16 or f32; ``fc1``/``fc2``: int8 QTensors, (d, ffn) and (ffn, d)
    in the (d_in, d_out) layout with (1, d_out) f32 scales; ``fc1_b``
    (ffn,), ``fc2_b`` (d,). ``block_f`` is the fc2-input re-quantization
    chunk (resolved as the reference does). The reference's VMEM row tile
    ``block_m`` does not change the result and has no counterpart here."""
    global launch_count, launch_count_f32
    if x.device.type == "cpu":
        return encoder_mlp_int8_resident_plain(
            x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f=block_f)
    out = _launch("K2", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f)
    launch_count += 1
    launch_count_f32 += int(x.dtype == torch.float32)
    return out


def encoder_mlp_int8(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b,
                     block_f: int = 640) -> torch.Tensor:
    """K8: the chunked kernel (``NWT_MLP_CHUNKED``), K2's function and
    arguments; the reference's ``block_m`` (``NWT_MLP_BM``) does not
    change the result and has no counterpart here."""
    global k8_launch_count, k8_launch_count_f32
    if x.device.type == "cpu":
        return encoder_mlp_int8_plain(
            x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f=block_f)
    out = _launch("K8", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f)
    k8_launch_count += 1
    k8_launch_count_f32 += int(x.dtype == torch.float32)
    return out


def _launch(key, x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f):
    m, d = x.shape
    ffn = fc1["q"].shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    block_f = resolve_block_f(block_f, ffn)
    if (key, x.dtype) not in _ENTRY or d % 128 or ffn % 128 or block_f % 128:
        raise ValueError(f"kernel takes bf16 or f32 x, d % 128 == 0 and a "
                         f"chunk that is a multiple of 128; got {x.dtype} "
                         f"d={d} ffn={ffn} block_f={block_f}")
    if (fc1["q"].dtype != torch.int8 or fc2["q"].dtype != torch.int8
            or tuple(fc1["q"].shape) != (d, ffn)
            or tuple(fc2["q"].shape) != (ffn, d)):
        raise ValueError("fc1/fc2 must be (d, ffn)/(ffn, d) int8 QTensors")
    from . import _build
    lib = _build.load("fused_mlp", _SIG)
    dev = x.device
    f32 = lambda z: z.to(device=dev, dtype=torch.float32).contiguous()
    x = x.contiguous()
    w1, w2 = fc1["q"].contiguous(), fc2["q"].contiguous()
    s1, s2 = f32(fc1["s"]).reshape(ffn), f32(fc2["s"]).reshape(d)
    g, be, b1, b2 = f32(ln_g), f32(ln_b), f32(fc1_b), f32(fc2_b)
    out = torch.empty_like(x)
    xq = torch.empty((m, d), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    a = torch.empty((m, ffn), dtype=torch.float32, device=dev)
    amax = torch.empty((m, ffn // block_f), dtype=torch.int32, device=dev)
    aq = torch.empty((m, ffn), dtype=torch.int8, device=dev)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = getattr(lib, _ENTRY[key, x.dtype])(
        ptr(x), ptr(g), ptr(be), ptr(w1), ptr(s1), ptr(b1),
        ptr(w2), ptr(s2), ptr(b2), ptr(out), ptr(xq), ptr(sx), ptr(a),
        ptr(amax), ptr(aq), m, d, ffn, block_f,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, _ENTRY[key, x.dtype])
    return out
