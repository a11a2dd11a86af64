"""K2, K8 and K7: fused LN + int8 fc1 + tanh gelu + int8 fc2 + residual.

Ports of ``ops/fused_mlp.py``'s two encoder MLP kernels (whisper.py:528-554):

* K2 :func:`encoder_mlp_int8_resident` (``encoder_mlp_int8_resident``), the
  quantized encoder's default, block_f 2560;
* K8 :func:`encoder_mlp_int8` (``encoder_mlp_int8``), taken under
  ``NWT_MLP_CHUNKED``, block_f 1280.

The TPU kernels compute one function and differ in what stays in VMEM; the
function's one parameter is ``block_f``, the width of the chunks in which
fc2's input is re-quantized. Both CUDA entry points live in
``csrc/fused_mlp.cu`` on the same templated kernels (int8 ``wgmma`` fed by
TMA, fc1's requantization across a thread-block cluster that spans one
chunk: :func:`fc1_plan`); its source note says what bounds them on an H100
and how the design answers that. The kernels read the weights K-major:
each QTensor's copy is made once, at its first launch
(``ops/quant.py::k_major``).

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its ``*_plain`` version for a CPU tensor. ``launch_count`` (K2) and
``k8_launch_count`` count kernel launches only, of both activation types:
bf16, and f32 for the int8 encoder at f32 compute (the reference's gates
test no dtype); ``launch_count_f32`` and ``k8_launch_count_f32`` count the
f32 launches alone.

K7 :func:`fused_mlp_q8` (``fused_mlp_q8``) is the decoder MLP for a few
rows with the int8 weights dequantized to bf16 (no requantization of the
activations). The reference keeps it as an op and its decoder does not
call it, nor does the port's. Its CUDA entry point is in
``csrc/fused_mlp_q8.cu``: two launches of K6's decode kernel
(``csrc/q8_decode.cuh``) a group of up to 32 rows, split as K6 splits the
same shapes; ``k7_launch_count`` counts calls, and
:func:`mlp_reference` is the reference's erf-gelu yardstick for it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .quant import int8_matmul_exact, k_major, ln_f32, quantize_rows

launch_count = 0
launch_count_f32 = 0
k8_launch_count = 0
k8_launch_count_f32 = 0
k7_launch_count = 0

_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY = {("K2", torch.bfloat16): "nwt_encoder_mlp_int8",
          ("K2", torch.float32): "nwt_encoder_mlp_int8_f32",
          ("K8", torch.bfloat16): "nwt_encoder_mlp_int8_chunked",
          ("K8", torch.float32): "nwt_encoder_mlp_int8_chunked_f32"}
_SIG = {fn: _ARGS for fn in _ENTRY.values()}
# csrc/fused_mlp.cu's fc1 tile widths and largest cluster (fc1_plan)
FC1_BN_WIDE, FC1_BN, MLP_MAX_CLUSTER = 160, 128, 16
_K7_ENTRY = {torch.bfloat16: "nwt_fused_mlp_q8",
             torch.float32: "nwt_fused_mlp_q8_f32"}
_K7_SIG = {fn: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
           + [ctypes.c_void_p] for fn in _K7_ENTRY.values()}
_K7_SIG["nwt_fused_mlp_q8_set_pdl"] = [ctypes.c_int]
K7_GROUP = 32   # csrc/fused_mlp_q8.cu's K7_GROUP: rows a pair of launches


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


def fc1_plan(block_f: int) -> Tuple[int, int]:
    """(tile width, cluster size) of K2's fc1 kernel for chunks of
    ``block_f`` columns, as ``csrc/fused_mlp.cu::fc1_plan`` chooses them:
    a cluster spans one chunk of a row tile, at most ``MLP_MAX_CLUSTER``
    blocks of ``FC1_BN_WIDE`` (else ``FC1_BN``) columns. Cluster 0: no
    cluster covers the chunk, and the kernel takes its two-pass variant
    (fc1's f32 output through device memory, then a requant pass)."""
    if block_f % FC1_BN_WIDE == 0 and \
            block_f // FC1_BN_WIDE <= MLP_MAX_CLUSTER:
        return FC1_BN_WIDE, block_f // FC1_BN_WIDE
    n = block_f // FC1_BN
    return FC1_BN, n if n <= MLP_MAX_CLUSTER else 0


def mlp_workspace(m: int, ffn: int, block_f: int, dev):
    """K2's device workspace for M rows: fc1's f32 output ``a`` (M, ffn)
    on the two-pass variant only (else one unused element), the per-(row,
    chunk) absmax bits and the int8 fc2 input."""
    two_pass = fc1_plan(block_f)[1] == 0
    a = torch.empty((m, ffn) if two_pass else (1,), dtype=torch.float32,
                    device=dev)
    amax = torch.empty((m, ffn // block_f), dtype=torch.int32, device=dev)
    aq = torch.empty((m, ffn), dtype=torch.int8, device=dev)
    return a, amax, aq


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
    _build.no_autograd("K2", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b)
    if x.device.type == "cpu":
        return encoder_mlp_int8_resident_plain(
            x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f=block_f)
    out = _launch("K2", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f)
    with _build.COUNT_LOCK:
        launch_count += 1
        launch_count_f32 += int(x.dtype == torch.float32)
    return out


def encoder_mlp_int8(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b,
                     block_f: int = 640) -> torch.Tensor:
    """K8: the chunked kernel (``NWT_MLP_CHUNKED``), K2's function and
    arguments; the reference's ``block_m`` (``NWT_MLP_BM``) does not
    change the result and has no counterpart here."""
    global k8_launch_count, k8_launch_count_f32
    _build.no_autograd("K8", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b)
    if x.device.type == "cpu":
        return encoder_mlp_int8_plain(
            x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f=block_f)
    out = _launch("K8", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b, block_f)
    with _build.COUNT_LOCK:
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
    lib = _build.load("fused_mlp", _SIG)
    dev = x.device
    # every converted tensor stays in a name until the launch has returned
    f32 = lambda z: z.to(device=dev, dtype=torch.float32).contiguous()
    x = x.contiguous()
    w1t, w2t = k_major(fc1), k_major(fc2)
    s1, s2 = f32(fc1["s"]).reshape(ffn), f32(fc2["s"]).reshape(d)
    g, be, b1, b2 = f32(ln_g), f32(ln_b), f32(fc1_b), f32(fc2_b)
    out = torch.empty_like(x)
    xq = torch.empty((m, d), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    a, amax, aq = mlp_workspace(m, ffn, block_f, dev)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = getattr(lib, _ENTRY[key, x.dtype])(
        ptr(x), ptr(g), ptr(be), ptr(w1t), ptr(s1), ptr(b1),
        ptr(w2t), ptr(s2), ptr(b2), ptr(out), ptr(xq), ptr(sx), ptr(a),
        ptr(amax), ptr(aq), m, d, ffn, block_f,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, _ENTRY[key, x.dtype])
    return out


# ---------------------------------------------------------------------------
# K7: the decoder MLP for small M, bf16-dequantized int8 weights
# ---------------------------------------------------------------------------

def _bf16_weight(qt) -> torch.Tensor:
    """w = bf16(bf16(q) * bf16(s)), as f32 (``_fused_mlp_kernel``)."""
    return (qt["q"].to(torch.bfloat16)
            * qt["s"].to(torch.bfloat16)).to(torch.float32)


def _warp_order_sum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of f32 ``v`` (M, K) in the order of one warp a row: lane
    l adds v[l], v[l + 32], ... in turn, then ``warp_sum``'s xor
    butterfly (offsets 16, 8, 4, 2, 1) adds the 32 lanes, which all end
    with lane 0's bits. (M, 1)."""
    m, k = v.shape
    lanes = torch.zeros((m, 32), dtype=torch.float32, device=v.device)
    for c in range(0, k, 32):
        part = v[:, c:c + 32]
        lanes[:, :part.shape[1]] = lanes[:, :part.shape[1]] + part
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
    return lanes


def ln_k7_order(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """K7's LayerNorm in its kernel's f32 arithmetic, op by op
    (``csrc/q8_decode.cuh::stage_rows``): mean = (lane-strided sum, then
    the warp butterfly) / K; var the same over the rounded squares of
    x - mean, / K; rstd = 1 / sqrt(var + eps); ((x - mean) * rstd) * g
    + b. Each step is one f32 torch op, correctly rounded on the CPU and
    on the card alike. The function of ``ln_f32`` in another summation
    order (which K1, K2, K8 and K10-K12's plain versions keep). x: (M,
    K) -> f32 (M, K)."""
    xf = x.to(torch.float32)
    # f32 scalars made on x's device (no host copy: a CUDA graph captures it)
    f32 = lambda z: torch.full((), z, dtype=torch.float32, device=xf.device)
    k = f32(float(xf.shape[-1]))
    mean = _warp_order_sum(xf) / k
    dv = xf - mean
    var = _warp_order_sum(dv * dv) / k
    rstd = f32(1.0) / torch.sqrt(var + f32(eps))
    return (dv * rstd) * g.to(torch.float32) + b.to(torch.float32)


def fused_mlp_q8_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b
                       ) -> torch.Tensor:
    """Plain PyTorch K7 at the Pallas kernel's rounding points: LN in f32
    (summed in the kernel's order, :func:`ln_k7_order`); ``bf16(h) @ w1 +
    b1`` with w1 = bf16(bf16(q1) bf16(s1)), exact products and f32 sums;
    tanh gelu in f32; ``bf16(a) @ w2 + b2``; ``f32(x) + o`` cast to x's
    dtype. x: (M, d)."""
    h = ln_k7_order(x, ln_g, ln_b)
    a = (h.to(torch.bfloat16).float() @ _bf16_weight(fc1)
         + fc1_b.reshape(1, -1).to(torch.float32))
    a = gelu_tanh(a)
    o = (a.to(torch.bfloat16).float() @ _bf16_weight(fc2)
         + fc2_b.reshape(1, -1).to(torch.float32))
    return (x.to(torch.float32) + o).to(x.dtype)


def k7_set_pdl(on: bool) -> None:
    """K7's fc2 by programmatic dependent launch (the default) or by a
    plain stream-ordered launch, for every call that follows in this
    process, on any thread: one process-wide switch for timing and testing
    both, not a per-call option (the card only)."""
    _build.load("fused_mlp_q8", _K7_SIG).nwt_fused_mlp_q8_set_pdl(int(on))


def fused_mlp_q8(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b) -> torch.Tensor:
    """K7: x + fc2(gelu_tanh(fc1(LN x))) with int8 QTensors ``fc1`` (d,
    ffn) and ``fc2`` (ffn, d) dequantized to bf16; x (M, d) bf16 or f32,
    M small (a decode step). Returns x's dtype."""
    global k7_launch_count
    _build.no_autograd("K7", x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b)
    m, d = x.shape
    ffn = fc1["q"].shape[-1]
    if x.device.type == "cpu":
        return fused_mlp_q8_plain(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _K7_ENTRY or d % 32 or ffn % 32:
        raise ValueError(f"K7 takes bf16 or f32 x with d and ffn multiples "
                         f"of 32; got {x.dtype} d={d} ffn={ffn}")
    if (fc1["q"].dtype != torch.int8 or fc2["q"].dtype != torch.int8
            or tuple(fc1["q"].shape) != (d, ffn)
            or tuple(fc2["q"].shape) != (ffn, d)):
        raise ValueError("fc1/fc2 must be (d, ffn)/(ffn, d) int8 QTensors")
    lib = _build.load("fused_mlp_q8", _K7_SIG)
    dev = x.device
    # every converted tensor stays in a name until the launch has returned;
    # the kernel's 16-byte loads want x, the LN and the weights aligned
    al = lambda z: z if z.data_ptr() % 16 == 0 else z.clone()
    f32 = lambda z: z.to(device=dev, dtype=torch.float32).contiguous()
    x = al(x.contiguous())
    w1, w2 = al(fc1["q"].contiguous()), al(fc2["q"].contiguous())
    s1, s2 = f32(fc1["s"]).reshape(ffn), f32(fc2["s"]).reshape(d)
    g, be, b1, b2 = al(f32(ln_g)), al(f32(ln_b)), f32(fc1_b), f32(fc2_b)
    act = torch.empty((m, ffn), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = getattr(lib, _K7_ENTRY[x.dtype])(
        ptr(x), ptr(g), ptr(be), ptr(w1), ptr(s1), ptr(b1), ptr(w2),
        ptr(s2), ptr(b2), ptr(act), ptr(out), m, d, ffn,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, _K7_ENTRY[x.dtype])
    with _build.COUNT_LOCK:
        k7_launch_count += 1
    return out


def mlp_reference(x, ln_g, ln_b, fc1, fc1_b, fc2, fc2_b) -> torch.Tensor:
    """The reference's yardstick for K7 (``mlp_reference``): the same
    MLP with the decoder's LayerNorm and exact erf gelu."""
    from ..models.whisper import _gelu, _layer_norm
    from .quant import dequantize_int8

    h = _layer_norm(x, ln_g, ln_b)
    a = (h.to(torch.bfloat16).float()
         @ dequantize_int8(fc1, torch.bfloat16).float() + fc1_b.float())
    a = _gelu(a)
    o = (a.to(torch.bfloat16).float()
         @ dequantize_int8(fc2, torch.bfloat16).float() + fc2_b.float())
    return (x.to(torch.float32) + o).to(x.dtype)
