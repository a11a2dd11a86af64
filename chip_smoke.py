#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nobs_whisper_torch``) on one
NVIDIA card, at the full width and depth of large-v3-turbo with weights
made from a seed.

Run from the repo root: ``python3 chip_smoke.py`` (one card, no
arguments; ``uni_moe`` as the one argument runs phases 1 and 18 alone).
Phases; any failure exits non-zero before the result line:

1. card and build: ``nvidia-smi`` name and power limit, torch/CUDA
   versions, one ``nvcc`` per kernel source started together, with the
   ``-Xptxas -v`` summary;
2. kernels against their plain PyTorch versions at turbo width (K1 at
   B=2, T=1536, n_real=1500; K2 at M=2*1536, block_f=2560, with bf16 and
   with f32 activations; K3 at B=2, T=1536, d=1280, H=20, n_real=1500; K9
   at B=2, H=10, T=1536, dh=128, at an odd head count, H=15, dh=64, at
   the ``NWT_INT8_QKV`` path's H=20, dh=64, and at dh=32, H=40):
   max error against the stated tolerance, kernel / plain / library ms
   (CUDA events) and the bound computed from the shapes against published
   H100 peaks; K2 and K8 also alone in a CUDA graph, split by kernel
   (``torch.profiler``: ln_quant, fc1, fc2), and K1 alone and split by
   part (ln_quant, the q/k/v GEMM, attention); the int8 GEMM kernels'
   yardstick is ``torch._int_mm`` on the weights as stored and on their
   K-major copies, both printed, the faster one kept;
3. small inputs against references: the f32 path against the oracle
   goldens (``tests/goldens/oracle_tiny.npz``: encoder states and greedy
   tokens); dh=64 encoders on the card against the same encoders' plain
   versions on the CPU: int8 at bf16 (K1, K2), float at bf16 (K3), int8
   at f32 (K2's f32 variant, no attention kernel);
4. serving through ``WhisperEngine.from_random(...).quantize()`` inside
   ``BatchedEngine(max_batch=8)``: five concurrent window requests (one
   auto-language), two more fixed-language ones, and one 45 s long-form
   request; launch counters reset just before and read just after must
   equal 32 x encoder batches; then one of the window requests again,
   one greedy rung of 224 steps, under ``torch.profiler`` for where the
   device time goes;
5. file transcription, the JAX package's default ``transcribe`` path:
   ``WhisperEngine.from_random("large-v3-turbo")`` unquantized at bf16,
   ``transcribe`` of a 12 s and a 45 s clip and of a 10 s clip on
   ``with_audio_ctx(750)`` (n_real 750 in a T=768 pad): K3 launches =
   32 x encoder batches, no other attention kernel; the same weights
   split into 10 heads of 128 (heads that do not pair) take K9 on every
   layer; one f32 int8 encoder batch at full width takes K2's f32 variant
   32 times and no K1; the CLI ``transcribe`` verb in a subprocess on a
   dh=64 tiny checkpoint and a WAV;
6. the decode-step kernels on their paths, under the reference's knobs
   (set in-process around each path and restored after): int8 cross-KV
   serving, ``BatchedEngine(quantized, max_batch=8,
   opts=DecodeOptions(q8_cross_kv=True))`` with ``NWT_Q8_KV_PALLAS=1`` and
   ``NWT_Q8_KERNEL_MIN_BYTES=1``, one concurrent wave of three requests
   (one auto-language) whose K5 and K6 launches must equal what the gates
   predict for the decoder forwards it ran (K1 = K2 = 32 x encoder
   batches, K4 = 0; K6 split into its decode-kernel launches, M <= 16,
   and its prefill-kernel ones), then one of them under
   ``torch.profiler``; and K4 on
   the file path (``NWT_XATTN_KERNEL=1``, one ``transcribe`` of a 12 s clip
   on the unquantized engine: K4 once a layer in each single-token
   forward, K6 = 0). With no knob set, no earlier phase launches K4, K5
   or K6;
7. the encoder's knob paths (``phase_encoder_knobs``): int8 serving with
   ``NWT_INT8_QKV NWT_MLP_CHUNKED NWT_STEM_FUSED`` (K13 once per encoder
   batch, K10, K9, K11 and K8 32 times per batch), a file transcription
   with ``NWT_STEM_FUSED`` (K13, K3), an f32 int8 encoder batch (the f32
   K10, K11 and K8), and one encoder batch under each of
   ``NWT_ATTN_FUSED=0``, ``NWT_NO_INT8_MLP`` and ``NWT_ATTN_BHTD``. With
   no knob set, no earlier phase launches K8, K10, K11 or K13;
8. the last encoder variants (``phase_attention_variants``): int8 serving
   with ``NWT_ATTN_FUSED=3`` (K12 32 times per encoder batch, no K1, K2,
   K3 or K8), one int8 encoder batch each with ``NWT_ATTN_FUSED=2`` (K1
   with the o projection fused, K2), ``NWT_ATTN_I8``, ``NWT_ATTN_I8PV``
   and both (that K1 variant, K2) and ``NWT_ATTN_FUSED=3`` with both (K12
   with both), a file transcription with both (K3 with both) and a float
   encoder batch with each alone (that K3 variant). With none of these
   knobs set, no earlier phase launches K12 or a K1/K3 variant;
9. the raw-PCM path and the two ops that no serving path takes
   (``phase_ops``): ``log_mel_spectrogram`` of one 30 s window on the
   card against the f64 oracle on the host; K14 through
   ``log_mel_spectrogram_pallas`` on wave 1's requests as 30 s windows
   (one launch); K7 through ``fused_mlp_q8`` on each int8 decoder MLP of
   the turbo engine (one launch a layer). Before it, every count read on
   phases 3-8 must show K7 = K14 = 0;
10. the session server (``phase_server``): the int8 turbo engine in
   ``BatchedEngine(max_batch=8)`` behind ``serve/server.py``, warmed up,
   configured with a language and a vocabulary over ``POST /config``,
   driven through ``client.py`` by three concurrent push-to-talk sessions
   (48 kHz, 0.5 s bodies, SSE to ``done``) and a ``/ws`` session, then one
   12 s WAV one-shot whose tokens must equal the direct call's; K1 = K2 =
   32 x encoder batches and no other kernel; ``tiktoken`` never loaded;
   then the ``serve`` verb in a subprocess, stopped by SIGINT;
11. beam search (``phase_beam``): the int8 turbo engine in
   ``BatchedEngine(max_batch=8)`` with ``beam_size=5`` (B x 5 rows over B
   shared packed cross-KV sets), a wave of five fixed-language windows
   and one auto-language window, then a 45 s long-form request: K1 = K2 =
   32 x encoder batches, no K4, K5 or K6, one language-detect forward;
   one request under ``torch.profiler``; ms per step of beam and greedy;
   the unquantized ``transcribe`` at beam 5 (K3); one beam batch under
   ``NWT_XATTN_KERNEL`` (K4 = 0 on grouped forwards) and under
   ``NWT_Q8_KERNEL_MIN_BYTES`` at B=1 and B=8 (K6 as predicted);
   ``NWT_BEAM_ANCESTRY`` against the permuted run. Phase 3 also holds
   beam on the golden model (``beam_tokens``, with and without
   ``NWT_BEAM_ANCESTRY``) and a dh=64 int8 model's beam tokens on the
   card to the CPU's;
12. the router (``phase_router``): the ``route`` verb in a subprocess
   over two managed ``serve --device cuda`` backends on the tiny
   checkpoint: aggregated ``/health``, least-loaded sessions, a ``/ws``
   tunnel, round-robin one-shots (one at ``?beam_size=3``), one rolling
   restart survived by a live session, SIGINT exit 0 with no backend
   left;
13. exact speculative greedy (``phase_speculative``): the int8 turbo
   engine in ``BatchedEngine(max_batch=8, speculative=3)``, self-draft
   over 4x pooled cross-KV, ladder off: a wave of five fixed-language
   windows and one auto-language window, then a 45 s long-form request,
   each row's tokens equal to the non-speculative ``BatchedEngine``'s or
   differing by a near-tie (``near_tie``: the sequential run's gap
   between the two tokens within the largest logit difference measured
   between the two runs' forwards on the same prefix); K1 = K2 = 32 x
   encoder batches, K4 = K5 = K6 = 0, ``emitted_per_pass`` as ``/stats``
   computes it; K6 under ``NWT_Q8_KERNEL_MIN_BYTES`` at B=1 and B=8 as
   the gates predict from the draft, verify and tail forwards; a
   second-model draft (``from_random("distil-large-v3")``, int8) held by
   the near-tie rule, and with it K4 (``NWT_XATTN_KERNEL``) and K5
   (``NWT_Q8_KV_PALLAS`` on int8 cross-KV) once a layer in each tail
   forward only; ``distil-small.en`` refused; a perfect self-draft's pass
   count; ms per emitted token against greedy at B=1 and B=8; one request
   under ``torch.profiler``. Phase 3 also holds the golden model's
   speculative tokens (K = 1 and 3, pool 1 and 2) to its greedy goldens
   and a dh=64 int8 model's speculative tokens on the card to the CPU's,
   at f32;
14. word timestamps (``phase_words``): ``transcribe`` of a 12 s clip with
   ``word_timestamps=True`` on the unquantized bf16 engine (K3) and on the
   int8 engine (K1, K2): words in order, each inside its segment, each
   window's words' tokens its text tokens; the golden model's alignment
   scores on the card within 1e-4 of the CPU's at f32, every token's
   boundaries equal; one ``POST /transcribe?word_timestamps=1`` on the
   int8 serving engine answers 200 with words;
15. the dp x tp mesh (``phase_mesh``): the int8 turbo engine through
   ``BatchedEngine(max_batch=8)`` on a dp=2 mesh (two cards if there are,
   else ``cuda:0`` twice), eight framed requests in one batch, every row
   held to the unsharded engine's by the near-tie rule and K1 = K2 = 2
   shards x 32 x batches; one window encoded and decoded on a dp=1 x tp=2
   mesh (states within ``TP_TOL`` of the unsharded plain path, K1 = K2 =
   0); ``serve --mesh 1x1`` in a subprocess;
16. native snapshots (``phase_native``): ``save_native``/``from_native``
   of the int8 turbo engine on the card (size, load time, parameters and
   a transcription's tokens equal), ``params_to_ggml_tensors`` ->
   ``write_ggml`` -> ``from_ggml`` at turbo width, ``resample_torch`` on
   the card against the CPU;
17. training, pp and sp (``phase_train``): the unquantized turbo weights
   as a trainable f32 tree on the card (TF32 off), a batch of two windows
   whose mel K14 makes; three full-depth ``train_step``s at lr 1e-3 (step
   times, peak memory; the loss finite and falling; no kernel launched);
   at 2 + 2 layers the step on the card against the CPU (loss and three
   leaves' gradients), the guard (the bf16 loss without the plain-ops
   context raises at K3), a dp=1 x tp=2 train step, ``encode_pipelined``
   on pp=2 and ``encode_seq_parallel`` on sp=2 against one device (two
   cards, or ``cuda:0`` twice), the gradient wrt the mel through the pp
   schedule; the trained weights quantized into a ``WhisperEngine``
   transcribe 12 s with K1 = K2 = 32;
18. the speech LM (``phase_uni_moe``): Uni-MoE-2.0-Omni's audio-to-text
   path at its published widths, random weights made on the card, a wave
   through ``BatchedEngine.transcribe`` whose ``moe_`` launches must be 4
   a layer a forward, and the expert kernels against their plain version
   at a decode batch (32 tokens) and a prefill (11,136 tokens), timed;
   ``python3 chip_smoke.py uni_moe`` runs phases 1 and 18 alone;
19. one ``kernels`` JSON line, then the result line.

Phase 2 also checks K4 (B=8, B=1 and B=16) and K5 (B=8 and B=1) at
H=20, Dh=64, Tp=1536, t_real=1500 (two calls bit for bit; timed back to
back and alone in a CUDA graph, cold over enough K/V sets to pass the L2
and over one set; each kernel's cluster size from its plan), K6 (the logit projection 1280 x 51,866 at M=8 with bf16
and with f32 x, two calls bit for bit with f32 x, fc1 1280 x 5120, fc2
5120 x 1280, M=256; the serving wave's prefill rows, M=24, at the logit
shape with f32 x and at fc2, each two calls bit for bit; each timed back
to back, alone in a CUDA graph and by the wrapper's host work), K10,
K11 and K8 (block_f=1280) at the knob paths' rows (d=1280; M=3000 with
bf16 and with f32 x, M=1500 with f32 x; timed back to back and alone in a
CUDA graph, the device time split by kernel) and K13 (3000 frames,
d=1280: B=2 with C_in=128 at t_out_pad 1536 and 1504 and with C_in=80,
and B=8; two calls bit for bit; timed back to back, alone in a CUDA graph,
and the wrapper's host work) and the variants at K1's shapes (K1 with fused o, K1 and
K3 with int8 scores, int8 PV and both, K12 and K12 with both at
ffn=5120, block_f=1280; the K1 and K12 rows also alone in a CUDA graph
and split by part: ln_quant, the q/k/v GEMM, int8_prep, attention, the o
quantization and the o GEMM, K12's fc1 and fc2; the K3 int8 variants'
device time split into the attention kernel and ``int8_prep``), K14 (B=40, B=2 and B=1 30 s
windows, 128 and 80 mels, against its plain version and the f64 oracle;
timed at B=40 and B=2 with 128: back to back, alone in a CUDA graph, and
the wrapper's host work) and K7 (d=1280, ffn=5120; M=8 and M=1, bf16 and
f32 x; fc2 with and without programmatic dependent launch); phase 3 also holds a d=128 dh=64 int8 decoder with the
three decode knobs on against the same model on the CPU (f32: greedy
tokens equal; bf16: prefill and step logits within a tolerance), and the
d=128 dh=64 int8 encoder with the three encoder knobs on (bf16 and f32),
with ``NWT_ATTN_FUSED=3`` and both int8 knobs, and with
``NWT_ATTN_FUSED=2``.

Imports nothing of JAX and nothing of ``nobs_whisper_tpu``.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time

from nobs_whisper_torch.utils.profiling import cuda_ms, graph_ms

# published H100 SXM peaks (dense): int8 tensor core, bf16 tensor core, HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32 on FFMA outside the tensor cores (K14)
PEAK_F32_FLOPS = 67e12

# K1 is held to one bf16 step of its plain version, elementwise:
# |kernel - plain| <= atol + rtol * |plain| (tests/test_torch_kernels.py
# holds the plain version to the Pallas kernel the same way): both share
# every rounding rule and differ only by f32 summation order, which can
# flip one bf16 output step. The JAX tests' 2e-2 (test_encoder_attention.py
# :201-204) stays as the ceiling on the max error.
K1_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K1_TOL = 2e-2
K2_TOL = 5e-2      # tests/test_fused_mlp.py:78
# K3 and K9 share K1's attention arithmetic and are held the same way:
# one bf16 step elementwise, 2e-2 (test_encoder_attention.py) as ceiling
ATTN_STEP, ATTN_TOL = K1_STEP, K1_TOL
# K4 and K5 keep the TPU kernels' rounding points and differ from their
# plain versions in f32 summation order only, which can flip one bf16
# probability: one bf16 step elementwise, 2e-2
# (test_attention_pallas.py:59,86) as ceiling
XATTN_STEP, XATTN_TOL = K1_STEP, K1_TOL
# K6 rounds the same bf16 operands as its plain version; the order (and in
# the tensor cores the rounding) of its f32 sums differs: 1e-3 absolute +
# 1e-3 relative on outputs of order 1
K6_TOL = dict(rtol=1e-3, atol=1e-3)
# the decode kernels' knobs (models/whisper.py), set around their paths
DECODE_KNOBS = ("NWT_XATTN_KERNEL", "NWT_Q8_KV_PALLAS",
                "NWT_Q8_KERNEL_MIN_BYTES")
# K10 and K11 share K2's int8 numerics: f32 summation order in LN and the
# row scales can flip one int8 activation, which moves its row's outputs
# by one int8 step times a weight; held, as K2, to the JAX tests' 0.05
# (tests/test_fused_qkv.py:37,51). K8 is K2's function: K2's bound.
QKV_TOL = 5e-2
# K13 rounds the same bf16 operands as its plain version at the same
# points; the order of its f32 sums differs, which can flip the bf16 sum
# before a gelu, and where the gelu is flat that one step of its input is
# several steps of its output: the JAX tests' 3e-2 (test_conv_stem.py:
# 34-36) on the max error, and rows >= t_real exact zeros
STEM_TOL = 3e-2
# the encoder's opt-in kernel knobs of this slice, set around their paths
SLICE_KNOBS = ("NWT_INT8_QKV", "NWT_MLP_CHUNKED", "NWT_STEM_FUSED")
KNOB_KERNELS = ("K8", "K10", "K11", "K13")
# K14's f32 FFT on FFMA rounds otherwise than its plain version's dense
# f32 DFT matmuls (TF32 off): the normalized log-mel is held to 1e-4, the bound
# tests/test_mel_pallas.py holds the Pallas kernel to, and the
# un-normalized log10 to the same bound in its units (4e-4) where it lies
# above each sample's max - 8 (below it the log10 of near-zero bins depends
# on the rounding; the clamp hides them), each against the plain version
# and against the f64 oracle
K14_TOL = 1e-4
# the two ops that no serving or transcribe path takes (the reference's
# decoder does not call K7; K14 is a drop-in for log_mel_spectrogram)
OP_KERNELS = ("K7", "K14")


def log(*a):
    print(*a, flush=True)


def phase_card_and_build():
    import torch
    from nobs_whisper_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build = _build.build_all(force=True)
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s wall for {len(build)} sources")
    for name, rec in build.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s")
        for line in rec["ptxas"].splitlines():
            if ("Compiling entry" in line or "Used" in line or "spill" in line
                    or "Performance Loss" in line):
                log(f"[ptxas]   {line.strip()}")
    return smi


def k1_setup(dev, b=2, h=20, t=1536, d=1280, seed=10):
    import torch
    from nobs_whisper_torch.ops.quant import quantize_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = (rn(b, t, d) * 0.5).to(torch.bfloat16)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    mkw = lambda: quantize_int8(rn(d, d) * d ** -0.5)
    wq, wk, wv = mkw(), mkw(), mkw()
    bq, bv = 0.1 * rn(d), 0.1 * rn(d)
    return x, ln_g, ln_b, wq, bq, wk, wv, bv


def k2_setup(dev, m=2 * 1536, d=1280, f=5120, seed=2):
    import torch
    from nobs_whisper_torch.ops.quant import quantize_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = (rn(m, d) * 0.5).to(torch.bfloat16)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    fc1, fc2 = quantize_int8(rn(d, f) * d ** -0.5), \
        quantize_int8(rn(f, d) * f ** -0.5)
    return x, ln_g, ln_b, fc1, 0.1 * rn(f), fc2, 0.1 * rn(d)


def int_mm_ms(pairs, extra=None):
    """The yardstick of an int8 GEMM kernel, timed here and used nowhere in
    the port: ``torch._int_mm`` of each (activation, weight) of ``pairs``
    (after ``extra()``, the attention kernels' SDPA, where given), the
    weight as stored ((K, N) row-major), and the same on its K-major copy
    (``w.t().contiguous().t()``, a column-major (K, N)), which cuBLAS
    serves with another kernel. (ms, ms) back to back."""
    import torch
    kmaj = [(a, w.t().contiguous().t()) for a, w in pairs]
    run = lambda ps: (extra and extra(), [torch._int_mm(a, w) for a, w in ps])
    return cuda_ms(lambda: run(pairs)), cuda_ms(lambda: run(kmaj))


def mlp_int_mm(m, d, f, args):
    """``int_mm_ms`` of K2's two GEMM shapes on ``args``' weights, on
    random int8 activations."""
    import torch
    dev = args[0].device
    a8 = torch.randint(-127, 128, (m, d), device=dev, dtype=torch.int8)
    h8 = torch.randint(-127, 128, (m, f), device=dev, dtype=torch.int8)
    return int_mm_ms([(a8, args[3]["q"]), (h8, args[5]["q"])])


def kernel_device_times(call):
    """A kernel's device time alone (the call in a CUDA graph) and its
    split by kernel (``torch.profiler``): K2's (or K8's) ln_quant, fc1 and
    fc2, and the memset and requant pass on the two-pass variant; K10's and
    K11's quantization pass and GEMM."""
    from nobs_whisper_torch.utils.profiling import device_ms_split
    alone = graph_ms(call)
    _, rest = device_ms_split(call, 10, "\0")
    short = lambda n: (n.split("(")[0].replace("void nwt::", "")
                       .split("<")[0])
    return alone, ", ".join(f"{short(n)} {t:.4f}" for n, t in rest)


def k1_device_times(call):
    """K1's (or K12's) device time alone (the call in a CUDA graph) and
    its split by part (``torch.profiler``: ln_quant, the q/k/v GEMM,
    int8_prep, attention, the o quantization and the o GEMM; K12's fc1 and
    fc2 besides), or why the split was not measured."""
    from nobs_whisper_torch.utils.profiling import device_ms_by_part
    alone = graph_ms(call)
    try:
        parts = device_ms_by_part(call, 10)
    except Exception as e:
        return alone, f"by part not measured: {e!r}"
    if not parts:
        return alone, "by part not measured: no device time in the trace"
    return alone, ", ".join(f"{k} {t:.4f}" for k, t in parts)


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    dev = torch.device("cuda")
    out = {}

    # ---- K1 ----
    b, h, t, d, n_real = 2, 20, 1536, 1280, 1500
    args = k1_setup(dev, b, h, t, d)
    sm = float(d // h) ** -0.5
    got = ea.encoder_attention_fused_qkv(*args, n_real, sm, h)
    torch.cuda.synchronize()
    ref = ea.encoder_attention_fused_qkv_plain(*args, n_real, sm, h)
    finite = bool(torch.isfinite(got.float()).all())
    diff = (got.float() - ref.float())[:, :n_real].abs()
    err = diff.max().item()
    steps = (diff / (K1_STEP["atol"] + K1_STEP["rtol"]
                     * ref.float()[:, :n_real].abs())).max().item()
    del diff
    call = lambda: ea.encoder_attention_fused_qkv(*args, n_real, sm, h)
    ms = cuda_ms(call)
    alone, parts = k1_device_times(call)
    plain_ms = cuda_ms(lambda: ea.encoder_attention_fused_qkv_plain(
        *args, n_real, sm, h), reps=3, warmup=1)
    qkv = [torch.randn(b, h, t, 64, device=dev, dtype=torch.bfloat16)
           for _ in range(3)]
    mask = torch.zeros(t, t, device=dev, dtype=torch.bool)
    mask[:, :n_real] = True          # (L, S): keys >= n_real masked
    m = b * t
    # the yardstick does K1's work: SDPA and the three int8 projections
    # (args[3], args[5], args[6]: wq, wk, wv)
    a8 = torch.randint(-127, 128, (m, d), device=dev, dtype=torch.int8)
    lib_kn, lib_km = int_mm_ms(
        [(a8, w["q"]) for w in (args[3], args[5], args[6])],
        lambda: F.scaled_dot_product_attention(*qkv, attn_mask=mask))
    lib_ms = min(lib_kn, lib_km)
    int8_ops = 2.0 * m * d * 3 * d
    bf16_flops = 2 * (2.0 * b * h * t * n_real * 64)
    nbytes = 2 * m * d * 2 + 3 * d * d + 3 * d * 4 + 4 * d * 4
    bound = max(int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS,
                nbytes / PEAK_BYTES) * 1e3
    ok1 = finite and steps <= 1.0 and err < K1_TOL
    log(f"[kernel] K1 encoder_attention_fused_qkv B={b} T={t} d={d} H={h} "
        f"n_real={n_real}: max_abs_err {err:.3e} (ceiling {K1_TOL}), "
        f"max |kernel - plain| / (atol + rtol |plain|) {steps:.3f} "
        f"(<= 1, {K1_STEP}) finite {finite} -> "
        f"{'PASS' if ok1 else 'FAIL'}; kernel "
        f"{ms:.4f} ms back to back, {alone:.4f} alone ({parts}), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"(operations), SDPA + torch._int_mm x3 (q/k/v projections) "
        f"{lib_kn:.4f} ms on the (K, N) weights, {lib_km:.4f} on their "
        f"K-major copies")
    out["K1"] = dict(
        name="encoder_attention_fused_qkv", route="cuda",
        source="nobs_whisper_torch/csrc/encoder_attention.cu",
        replaces="nobs_whisper_tpu/ops/encoder_attention.py:565",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations", library_ms=lib_ms, ok=ok1)
    del args, got, ref, qkv, a8

    # ---- K2 ----
    m, d, f, bf = 2 * 1536, 1280, 5120, 2560
    args = k2_setup(dev, m, d, f)
    got = fm.encoder_mlp_int8_resident(*args, block_f=bf)
    torch.cuda.synchronize()
    ref = fm.encoder_mlp_int8_resident_plain(*args, block_f=bf)
    err = (got.float() - ref.float()).abs().max().item()
    call = lambda: fm.encoder_mlp_int8_resident(*args, block_f=bf)
    ms = cuda_ms(call)
    alone, split = kernel_device_times(call)
    plain_ms = cuda_ms(lambda: fm.encoder_mlp_int8_resident_plain(
        *args, block_f=bf), reps=3, warmup=1)
    lib_kn, lib_km = mlp_int_mm(m, d, f, args)
    lib_ms = min(lib_kn, lib_km)
    ops = 2.0 * m * d * f * 2
    nbytes = 2 * m * d * 2 + 2 * d * f + (f + d) * 4 * 2 + 2 * d * 4
    bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
    ok2 = err < K2_TOL
    log(f"[kernel] K2 encoder_mlp_int8_resident M={m} d={d} ffn={f} "
        f"block_f={bf}: max_abs_err {err:.3e} (tol {K2_TOL}) -> "
        f"{'PASS' if ok2 else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"{alone:.4f} alone ({split}), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (operations), "
        f"torch._int_mm fc1+fc2 {lib_kn:.4f} ms on the (K, N) weights, "
        f"{lib_km:.4f} on their K-major copies")
    out["K2"] = dict(
        name="encoder_mlp_int8_resident", route="cuda",
        source="nobs_whisper_torch/csrc/fused_mlp.cu",
        replaces="nobs_whisper_tpu/ops/fused_mlp.py:298",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations", library_ms=lib_ms, ok=ok2)
    del got, ref

    # ---- K2, f32 activations (the int8 encoder at f32 compute) ----
    x32 = args[0].float() + 1e-3 * torch.randn(m, d, device=dev)
    got = fm.encoder_mlp_int8_resident(x32, *args[1:], block_f=bf)
    torch.cuda.synchronize()
    ref = fm.encoder_mlp_int8_resident_plain(x32, *args[1:], block_f=bf)
    err = (got - ref).abs().max().item()
    call = lambda: fm.encoder_mlp_int8_resident(x32, *args[1:], block_f=bf)
    ms = cuda_ms(call)
    alone, split = kernel_device_times(call)
    plain_ms = cuda_ms(lambda: fm.encoder_mlp_int8_resident_plain(
        x32, *args[1:], block_f=bf), reps=3, warmup=1)
    nbytes = 2 * m * d * 4 + 2 * d * f + (f + d) * 4 * 2 + 2 * d * 4
    bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
    ok2f = err < K2_TOL and got.dtype == torch.float32
    log(f"[kernel] K2-f32 encoder_mlp_int8_resident f32 M={m} d={d} "
        f"ffn={f} block_f={bf}: max_abs_err {err:.3e} (tol {K2_TOL}) -> "
        f"{'PASS' if ok2f else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"{alone:.4f} alone ({split}), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (operations), "
        f"torch._int_mm fc1+fc2 {lib_kn:.4f} ms on the (K, N) weights, "
        f"{lib_km:.4f} on their K-major copies")
    out["K2-f32"] = dict(
        name="encoder_mlp_int8_resident (f32 activations)", route="cuda",
        source="nobs_whisper_torch/csrc/fused_mlp.cu",
        replaces="nobs_whisper_tpu/ops/fused_mlp.py:298",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations", library_ms=lib_ms, ok=ok2f)
    del args, got, ref, x32
    torch.cuda.empty_cache()

    # ---- K3 (flat layout) and K9 (per head) ----
    out["K3"] = attention_kernel_check(
        "K3", "encoder_attention_btd", "nobs_whisper_tpu/ops/"
        "encoder_attention.py:185", b=2, h=20, t=1536, dh=64, n_real=1500)
    out["K9"] = attention_kernel_check(
        "K9", "encoder_attention", "nobs_whisper_tpu/ops/"
        "encoder_attention.py:93", b=2, h=10, t=1536, dh=128, n_real=1500)
    # the odd head count, and the NWT_INT8_QKV path's own grid (20 heads
    # of 64, the stem's 1500 rows padded to 1536 around each attention)
    # and the narrowest head width the kernel is built for
    for h, dh in ((15, 64), (20, 64), (40, 32)):
        _join(out, "K9", attention_kernel_check(
            "K9", "encoder_attention", "", b=2, h=h, t=1536, dh=dh,
            n_real=1500))
    torch.cuda.empty_cache()
    out.update(decode_kernel_checks())
    torch.cuda.empty_cache()
    out.update(knob_kernel_checks())
    torch.cuda.empty_cache()
    out.update(variant_kernel_checks())
    torch.cuda.empty_cache()
    out.update(op_kernel_checks())
    torch.cuda.empty_cache()
    return out


# The last encoder variants, held to their plain versions on the card
# (tests/test_torch_kernels_gpu.py::VAR_TOL): the attention-only variants
# (K1 and K3 with int8 scores or PV) to 2e-2 on the max and 1e-4 on the
# mean (a flipped LN1 int8 activation in the row that holds a head's absmax
# of k or v moves that head's scale); K1 with the o projection fused to
# K2's 5e-2 and a mean of 2e-4 (an int8 flip of its requantized input
# moves a row; with int8 scores a moved head scale feeds that flip);
# K12 end to end to 1e-1 and a mean of 5e-3: its bf16 x2 differs from the
# plain one by a bf16 step in 7% of the elements at turbo width (one int8
# flip of the o input moves its row by about half a step), so in most
# rows, and LN2 requantizes each such row. K12 is besides held bit for
# bit to K1 with fused o then K2 (its kernels on one stream), and its MLP
# half, on the kernel's own x2, to K2's 5e-2.
VAR_TOL = {"attn": (2e-2, 1e-4), "o": (5e-2, 2e-4), "K12": (1e-1, 5e-3)}
# the variants' knobs (models/whisper.py::encoder_kernel_gates)
VARIANT_KNOBS = ("NWT_ATTN_FUSED", "NWT_ATTN_I8", "NWT_ATTN_I8PV")


def variant_names():
    """Every variant counter: K1 with fused o and/or int8 scores / PV, K3
    with int8 scores / PV, K12 and its int8 variants."""
    from nobs_whisper_torch.utils.testing import KernelSpies
    return [n for k in ("K1", "K3", "K12") for n in KernelSpies.VARIANTS[k]
            if n not in ("K1", "K3")]


def _var_err(got, ref, n_real, kind):
    import torch
    tol, mean = VAR_TOL[kind]
    diff = (got.float() - ref.float())[:, :n_real].abs()
    err, avg = diff.max().item(), diff.mean().item()
    frac = (diff > 0).float().mean().item()
    ok = (err < tol and avg < mean and got.dtype == torch.bfloat16
          and bool(torch.isfinite(got.float()).all()))
    return err, avg, frac, ok


def variant_kernel_checks():
    """K1 with fused o; K1 and K3 with int8 scores, int8 PV and both; K12
    and K12 with both int8 variants: at turbo shapes (B = 2 windows, T =
    1536, n_real = 1500, d = 1280, H = 20, ffn = 5120, K12's block_f 1280)
    against their plain versions on the card. Bounds: the int8 and bf16
    work of each at the published peaks, summed, against the bytes in and
    out. Yardsticks, timed here and used nowhere in the port, each doing
    its kernel's work: SDPA on the same bf16 q/k/v (K3); SDPA plus
    ``torch._int_mm`` of the three (d, d) q/k/v projections at M = B T
    (K1; K1-o adds the o projection's); for K12 SDPA plus
    ``torch._int_mm`` of the layer's six int8 GEMM shapes."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.ops.quant import quantize_int8
    dev = torch.device("cuda")
    b, h, t, d, f, n_real, bf = 2, 20, 1536, 1280, 5120, 1500, 1280
    m = b * t
    sm = 0.125
    out = {}
    qkv = [torch.randn(b, h, t, 64, device=dev, dtype=torch.bfloat16)
           for _ in range(3)]
    mask = torch.zeros(1, t, device=dev, dtype=torch.bool)
    mask[:, :n_real] = True
    sdpa = lambda: F.scaled_dot_product_attention(*qkv, attn_mask=mask,
                                                  scale=sm)
    sdpa_ms = cuda_ms(sdpa)
    attn_ops = 2.0 * b * h * t * n_real * 64     # QK^T, and again PV

    def attn_bound(s8, pv, int8_ops, nbytes):
        i8 = int8_ops + attn_ops * (s8 + pv)
        b16 = attn_ops * (2 - s8 - pv)
        return _bound_mixed(nbytes, i8, b16)

    def check(key, kind, fn, plain, bound, lib_ms, lib_name, source,
              replaces, name, shape, parts=False):
        got = fn()
        torch.cuda.synchronize()
        ref = plain()
        err, avg, frac, ok = _var_err(got, ref, n_real, kind)
        del got, ref
        ms = cuda_ms(fn)
        split = ""
        if parts:   # K1's and K12's: alone, and by part
            alone, split = k1_device_times(fn)
            split = f" back to back, {alone:.4f} alone ({split})"
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        tol = VAR_TOL[kind]
        log(f"[kernel] {key} {name} {shape}: max_abs_err {err:.3e} mean "
            f"{avg:.3e}, {frac:.2e} of elements differ "
            f"(tol {tol[0]}, mean {tol[1]}) -> {'PASS' if ok else 'FAIL'}; "
            f"kernel {ms:.4f} ms{split}, plain {plain_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), {lib_name} " + (
                f"{lib_ms[0]:.4f} ms on the (K, N) weights, {lib_ms[1]:.4f} "
                "on their K-major copies" if isinstance(lib_ms, tuple)
                else f"{lib_ms:.4f} ms"))
        out[key] = _entry(f"{name} ({key})", source, replaces, err, ms,
                          plain_ms, bound, min(lib_ms) if isinstance(
                              lib_ms, tuple) else lib_ms, ok)

    # ---- K1: fused o, int8 scores / PV ----
    args = k1_setup(dev, b, h, t, d, seed=14)
    g = torch.Generator(device=dev).manual_seed(15)
    wo = quantize_int8(torch.randn(d, d, generator=g, device=dev) * d ** -0.5)
    bo = 0.1 * torch.randn(d, generator=g, device=dev)
    a8 = torch.randint(-127, 128, (m, d), device=dev, dtype=torch.int8)
    proj = (args[3], args[5], args[6], wo)          # wq, wk, wv, wo
    k1_lib = {n: int_mm_ms([(a8, w["q"]) for w in proj[:n]], sdpa)
              for n in (3, 4)}
    proj_ops = 2.0 * m * d * 3 * d
    for fuse_o, s8, pv in ((True, False, False), (False, True, False),
                           (False, False, True), (False, True, True)):
        kw = dict(int8_scores=s8, int8_pv=pv,
                  **(dict(wo=wo, bo=bo) if fuse_o else {}))
        key = ea.variant("K1", fuse_o, s8, pv)
        nbytes = 2 * m * d * 2 + (3 + fuse_o) * d * d + 8 * d * 4
        bound = attn_bound(s8, pv, proj_ops + fuse_o * 2.0 * m * d * d,
                           nbytes)
        check(key, "o" if fuse_o else "attn",
              lambda: ea.encoder_attention_fused_qkv(*args, n_real, sm, h,
                                                     **kw),
              lambda: ea.encoder_attention_fused_qkv_plain(*args, n_real, sm,
                                                           h, **kw),
              bound, k1_lib[3 + fuse_o],
              f"SDPA + torch._int_mm x{3 + fuse_o} (the projections)",
              "encoder_attention.cu",
              "encoder_attention.py:565", "encoder_attention_fused_qkv",
              f"B={b} T={t} d={d} H={h} n_real={n_real}", parts=True)
    torch.cuda.empty_cache()

    # ---- K3: int8 scores / PV ----
    gq = torch.Generator(device=dev).manual_seed(16)
    q, k, v = ((torch.randn(b, t, d, generator=gq, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(3))
    for s8, pv in ((True, False), (False, True), (True, True)):
        key = ea.variant("K3", False, s8, pv)
        fn = lambda: ea.encoder_attention_btd(q, k, v, n_real, sm, h,
                                              int8_scores=s8, int8_pv=pv)
        check(key, "attn", fn,
              lambda: ea.encoder_attention_btd_plain(q, k, v, n_real, sm, h,
                                                     s8, pv),
              attn_bound(s8, pv, 0, 4 * m * d * 2), sdpa_ms, "SDPA",
              "encoder_attention.cu", "encoder_attention.py:185",
              "encoder_attention_btd", f"B={b} T={t} H={h} dh=64 "
              f"n_real={n_real}")
        split = attn_prep_ms(fn)
        log(f"[kernel] {key} device time by part (torch.profiler, one call "
            f"of 10): " + ("not measured: " + split if isinstance(split, str)
                           else f"attention kernel {split[0]:.4f} ms, "
                           f"int8_prep {split[1]:.4f} ms ({split[2]})"))
    del q, k, v
    torch.cuda.empty_cache()

    # ---- K12 ----
    x, g1, b1n, wq, bq, wk, wv, bv = args
    _, g2, b2n, fc1, fc1_b, fc2, fc2_b = k2_setup(dev, 8, d, f, seed=17)
    largs = (x, g1, b1n, wq, bq, wk, wv, bv, wo, bo, g2, b2n, fc1, fc1_b,
             fc2, fc2_b)
    h8 = torch.randint(-127, 128, (m, f), device=dev, dtype=torch.int8)
    lib_ms = int_mm_ms([(a8, w["q"]) for w in (wq, wk, wv, wo, fc1)]
                       + [(h8, fc2["q"])], sdpa)
    layer_ops = 2.0 * m * d * (4 * d + 2 * f)
    nbytes = 2 * m * d * 2 + 4 * d * d + 2 * d * f + (13 * d + 2 * f) * 4
    for s8, pv in ((False, False), (True, True)):
        key = ea.variant("K12", False, s8, pv)
        halves_ok = k12_halves_check(largs, n_real, sm, h, bf, s8, pv, key)
        check(key, "K12",
              lambda: fl.encoder_layer_fused(*largs, n_real, sm, h,
                                             block_f=bf, int8_scores=s8,
                                             int8_pv=pv),
              lambda: fl.encoder_layer_fused_plain(*largs, n_real, sm, h,
                                                   block_f=bf,
                                                   int8_scores=s8,
                                                   int8_pv=pv),
              attn_bound(s8, pv, layer_ops, nbytes), lib_ms,
              "SDPA + torch._int_mm x6 (the layer's GEMM shapes)",
              "fused_layer.cu", "fused_layer.py:217", "encoder_layer_fused",
              f"B={b} T={t} d={d} H={h} ffn={f} block_f={bf} "
              f"n_real={n_real}", parts=True)
        out[key]["ok"] &= halves_ok
    return out


def attn_prep_ms(fn, reps=10):
    """Device time per call of an int8 attention variant's wrapper ``fn``,
    split by kernel from torch.profiler over ``reps`` calls: the attention
    kernel (``attn_wgmma_kernel``) and the rest, ``int8_prep``'s two
    launches. Returns (attention ms, prep ms, the prep kernels'
    names), or the reason it was not measured."""
    import torch
    from nobs_whisper_torch.utils.profiling import device_ms_split
    fn()
    torch.cuda.synchronize()
    try:
        attn, prep = device_ms_split(fn, reps, "attn_wgmma_kernel")
    except Exception as e:
        return repr(e)
    if not attn or not prep:
        return f"no device time in the trace ({attn}, {prep})"
    names = ", ".join(f"{n.split('(')[0][:40]} {t:.4f}" for n, t in prep)
    return attn, sum(t for _, t in prep), names


def k12_halves_check(largs, n_real, sm, h, bf, s8, pv, key):
    """K12 on the card against its two halves: bit for bit K1 with fused o
    then K2 at K12's chunk (the same kernels on one stream), and its MLP
    half on the kernel's own x2 within K2's 5e-2 of K2's plain version."""
    import torch
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.ops import fused_mlp as fm
    b, t, d = largs[0].shape
    got = fl.encoder_layer_fused(*largs, n_real, sm, h, block_f=bf,
                                 int8_scores=s8, int8_pv=pv)
    x2 = ea.encoder_attention_fused_qkv(
        *largs[:8], n_real, sm, h, int8_scores=s8, int8_pv=pv,
        wo=largs[8], bo=largs[9]).reshape(b * t, d)
    want = fm.encoder_mlp_int8_resident(x2, *largs[10:], block_f=bf)
    torch.cuda.synchronize()
    exact = torch.equal(got.reshape(b * t, d), want)
    half = fm.encoder_mlp_int8_resident_plain(x2, *largs[10:], block_f=bf)
    err = (want.float() - half.float()).reshape(b, t, d)[:, :n_real].abs()
    err = err.max().item()
    ok = exact and err < K2_TOL
    log(f"[kernel] {key} halves: K12 == K2(K1 with fused o) on the card bit "
        f"for bit {exact}; MLP half on the kernel's x2 vs K2 plain max_abs_err "
        f"{err:.3e} (tol {K2_TOL}) -> {'PASS' if ok else 'FAIL'}")
    return ok


def _bound_mixed(nbytes, int8_ops, bf16_flops):
    """(bound ms, what bounds it): int8 and bf16 tensor-core work at their
    published peaks, one after the other, against the bytes."""
    tb = nbytes / PEAK_BYTES
    to = int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _bound_int8(nbytes, ops):
    """(bound ms, what bounds it) for int8 tensor-core work."""
    tb, to = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _join(out, key, e):
    """Fold a further check of kernel ``key`` into its line's entry: its
    pass joins the entry's, its error raises the entry's if larger; the
    first check's times and bound stay the line's."""
    if key not in out:
        out[key] = e
        return
    out[key]["ok"] &= e["ok"]
    out[key]["max_abs_err"] = max(out[key]["max_abs_err"], e["max_abs_err"])


def _entry(name, source, replaces, err, ms, plain_ms, bound, lib_ms, ok):
    return dict(name=name, route="cuda",
                source=f"nobs_whisper_torch/csrc/{source}",
                replaces=f"nobs_whisper_tpu/ops/{replaces}", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib_ms, ok=ok)


# The rows K10, K11 and K8 take on the knob paths: 1500 per window (the
# K9 path does not pad the stem's rows), so 3000 for the serving wave's
# batches of two and 1500 for the f32 encoder batch; neither is a
# multiple of the 128-row tile. Each line keeps the times and bound of
# its first shape; the others join its pass and error.
KNOB_ROWS = (("bfloat16", 3000), ("float32", 3000), ("float32", 1500))


def knob_kernel_checks():
    """K10, K11 and K8 (block_f = 1280) at ``KNOB_ROWS``, d = 1280. K13 at
    B = 2, 3000 frames, d = 1280: C_in = 128 at t_out_pad 1536 (the flat
    path) and 1504 (the K9 path), and C_in = 80; and at B = 8, C_in = 128,
    t_out_pad 1536. Yardsticks, timed here
    and used nowhere in the port: ``torch._int_mm`` of the same int8
    shapes (K10: three, K11: one, K8: K2's two), and two bf16
    ``F.conv1d`` with the same weights (K13)."""
    import torch
    out = {}
    for dt, m in KNOB_ROWS:
        xd = getattr(torch, dt)
        tag = "" if xd == torch.bfloat16 else "-f32"
        for key, e in qkv_checks(m, xd).items():
            _join(out, key + tag, e)
        torch.cuda.empty_cache()
        _join(out, "K8" + tag, k8_check(m, xd))
        torch.cuda.empty_cache()
    # K13: the line keeps C_in = 128 at the flat path's 1536 rows; B = 8
    # is the serving batcher's max_batch
    for c_in, t_pad, b in ((128, 1536, 2), (128, 1504, 2), (80, 1536, 2),
                           (128, 1536, 8)):
        _join(out, "K13", stem_check(c_in, t_pad, b))
        torch.cuda.empty_cache()
    return out


def qkv_checks(m, xd, d=1280):
    """K10 and K11 at (m, d) with activations of type ``xd`` against their
    plain versions on the card."""
    import torch
    from nobs_whisper_torch.ops import fused_qkv as fq
    dev = torch.device("cuda")
    tag = "" if xd == torch.bfloat16 else "-f32"
    x, ln_g, ln_b, wq, bq, wk, wv, bv = k1_setup(dev, 1, 20, m, d, seed=12)
    x = x[0].to(xd)
    a = (torch.randn(m, d, device=dev) * 0.5).to(xd)
    eb = x.element_size()
    a8 = torch.randint(-127, 128, (m, d), device=dev, dtype=torch.int8)
    lib3_kn, lib3_km = int_mm_ms([(a8, w["q"]) for w in (wq, wk, wv)])
    lib1_kn, lib1_km = int_mm_ms([(a8, wq["q"])])
    lib3, lib1 = min(lib3_kn, lib3_km), min(lib1_kn, lib1_km)
    out = {}
    # K10
    args = (x, ln_g, ln_b, wq, bq, wk, wv, bv)
    got = fq.encoder_qkv_int8(*args)
    torch.cuda.synchronize()
    ref = fq.encoder_qkv_int8_plain(*args)
    err = max((g.float() - r.float()).abs().max().item()
              for g, r in zip(got, ref))
    ok = err < QKV_TOL and all(g.dtype == xd for g in got) and all(
        bool(torch.isfinite(g.float()).all()) for g in got)
    call = lambda: fq.encoder_qkv_int8(*args)
    ms = cuda_ms(call)
    alone, split = kernel_device_times(call)
    plain_ms = cuda_ms(lambda: fq.encoder_qkv_int8_plain(*args),
                       reps=3, warmup=1)
    nbytes = 4 * m * d * eb + 3 * d * d + 8 * d * 4
    bound = _bound_int8(nbytes, 3 * 2.0 * m * d * d)
    log(f"[kernel] K10{tag} encoder_qkv_int8 M={m} d={d} x {xd}: "
        f"max_abs_err {err:.3e} (tol {QKV_TOL}) -> "
        f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"{alone:.4f} alone ({split}), plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
        f"{nbytes / 1e6:.1f} MB), torch._int_mm x3 {lib3_kn:.4f} ms on the "
        f"(K, N) weights, {lib3_km:.4f} on their K-major copies")
    out["K10"] = _entry(
        "encoder_qkv_int8" + (" (f32 activations)" if tag else ""),
        "fused_qkv.cu", "fused_qkv.py:79", err, ms, plain_ms, bound,
        lib3, ok)
    del got, ref
    # K11
    args = (x, a, wq, bq)
    got = fq.residual_o_int8(*args)
    torch.cuda.synchronize()
    ref = fq.residual_o_int8_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    ok = err < QKV_TOL and got.dtype == xd and \
        bool(torch.isfinite(got.float()).all())
    call = lambda: fq.residual_o_int8(*args)
    ms = cuda_ms(call)
    alone, split = kernel_device_times(call)
    plain_ms = cuda_ms(lambda: fq.residual_o_int8_plain(*args), reps=3,
                       warmup=1)
    nbytes = 3 * m * d * eb + d * d + 2 * d * 4
    bound = _bound_int8(nbytes, 2.0 * m * d * d)
    log(f"[kernel] K11{tag} residual_o_int8 M={m} d={d} x {xd}: "
        f"max_abs_err {err:.3e} (tol {QKV_TOL}) -> "
        f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"{alone:.4f} alone ({split}), plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
        f"{nbytes / 1e6:.1f} MB), torch._int_mm {lib1_kn:.4f} ms on the "
        f"(K, N) weight, {lib1_km:.4f} on its K-major copy")
    out["K11"] = _entry(
        "residual_o_int8" + (" (f32 activations)" if tag else ""),
        "fused_qkv.cu", "fused_qkv.py:131", err, ms, plain_ms, bound,
        lib1, ok)
    return out


def k8_check(m, xd, d=1280, f=5120, bf=1280):
    """K8, K2's function at the chunked kernel's block_f, at (m, d) with
    activations of type ``xd`` against its plain version on the card."""
    import torch
    from nobs_whisper_torch.ops import fused_mlp as fm
    dev = torch.device("cuda")
    tag = "" if xd == torch.bfloat16 else "-f32"
    args = k2_setup(dev, m, d, f, seed=8)
    args = (args[0].to(xd),) + args[1:]
    lib_kn, lib_km = mlp_int_mm(m, d, f, args)
    lib_ms = min(lib_kn, lib_km)
    got = fm.encoder_mlp_int8(*args, block_f=bf)
    torch.cuda.synchronize()
    ref = fm.encoder_mlp_int8_plain(*args, block_f=bf)
    err = (got.float() - ref.float()).abs().max().item()
    ok = err < K2_TOL and got.dtype == xd and \
        bool(torch.isfinite(got.float()).all())
    call = lambda: fm.encoder_mlp_int8(*args, block_f=bf)
    ms = cuda_ms(call)
    alone, split = kernel_device_times(call)
    plain_ms = cuda_ms(lambda: fm.encoder_mlp_int8_plain(
        *args, block_f=bf), reps=3, warmup=1)
    nbytes = 2 * m * d * args[0].element_size() + 2 * d * f + \
        (f + d) * 4 * 2 + 2 * d * 4
    bound = _bound_int8(nbytes, 2.0 * m * d * f * 2)
    log(f"[kernel] K8{tag} encoder_mlp_int8 M={m} d={d} ffn={f} "
        f"block_f={bf} x {xd}: max_abs_err {err:.3e} (tol {K2_TOL}) -> "
        f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"{alone:.4f} alone ({split}), plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
        f"torch._int_mm fc1+fc2 {lib_kn:.4f} ms on the (K, N) weights, "
        f"{lib_km:.4f} on their K-major copies")
    return _entry("encoder_mlp_int8" + (" (f32 activations)" if tag else ""),
                  "fused_mlp.cu", "fused_mlp.py:173", err, ms, plain_ms,
                  bound, lib_ms, ok)


def stem_check(c_in, t_pad, b=2, n_frames=3000, d=1280, seed=13):
    """K13 at one geometry against its plain version (both on the card):
    the max error, the padded rows exact zeros, and the same bits from two
    calls. Timed three ways: back-to-back calls of the wrapper (the line's
    ``ms``), the kernels alone on the device (``graph_ms``: the call
    captured in a CUDA graph), and the wrapper's host work a call (host
    clock over calls that enqueue without waiting). The yardstick is the
    two bf16 ``F.conv1d`` of the unfused stem on the same bf16 mel and
    weights (their weight permutes made before timing), back to back and
    alone in a CUDA graph."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import conv_stem as cs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + c_in + t_pad + b)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    mel = rn(b, c_in, n_frames) * 0.5
    w1 = (rn(3, c_in, d) * (3 * c_in) ** -0.5).to(torch.bfloat16)
    w2 = (rn(3, d, d) * (3 * d) ** -0.5).to(torch.bfloat16)
    b1, b2 = (0.1 * rn(d)).to(torch.bfloat16), (0.1 * rn(d)).to(torch.bfloat16)
    pos = (0.1 * rn(n_frames // 2, d)).to(torch.bfloat16)
    args = (mel, w1, b1, w2, b2, pos, t_pad)
    t_half = n_frames // 2
    got = cs.encoder_stem_fused(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, cs.encoder_stem_fused(*args)))
    ref = cs.encoder_stem_fused_plain(*args)
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    frac = (diff > 0).float().mean().item()
    zeros = not bool(got[:, t_half:].any())
    ok = err < STEM_TOL and zeros and same and got.shape == (b, t_pad, d) \
        and bool(torch.isfinite(got.float()).all())
    del got, ref, diff
    call = lambda: cs.encoder_stem_fused(*args)
    ms = cuda_ms(call)
    device_ms = graph_ms(call, reps=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: cs.encoder_stem_fused_plain(*args), reps=3,
                       warmup=1)
    xb = mel.to(torch.bfloat16)
    k1 = w1.permute(2, 1, 0).contiguous()
    k2 = w2.permute(2, 1, 0).contiguous()
    a = torch.randn(b, d, n_frames, device=dev, dtype=torch.bfloat16)
    convs = lambda: (F.conv1d(xb, k1, b1, padding=1),
                     F.conv1d(a, k2, b2, stride=2, padding=1))
    lib_ms = cuda_ms(convs)
    lib_alone = graph_ms(convs, reps=20)
    flops = 2.0 * b * n_frames * 3 * c_in * d + 2.0 * b * t_half * 3 * d * d
    nbytes = (mel.numel() * 4 + (w1.numel() + w2.numel() + pos.numel()) * 2
              + 2 * d * 2 + b * t_pad * d * 2)
    bound = _bound(nbytes, flops)
    log(f"[kernel] K13 encoder_stem_fused B={b} C_in={c_in} frames="
        f"{n_frames} d={d} t_out_pad={t_pad}: max_abs_err {err:.3e} (tol "
        f"{STEM_TOL}), {frac:.2e} of elements differ, rows >= {t_half} zero "
        f"{zeros}, two calls bit for bit {same} -> "
        f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"{device_ms:.4f} alone in a CUDA graph, the wrapper's host work "
        f"{host_ms:.4f} ms a call; plain {plain_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}, {nbytes / 1e6:.1f} MB), F.conv1d "
        f"x2 (bf16) {lib_ms:.4f} ms back to back, {lib_alone:.4f} alone")
    return _entry("encoder_stem_fused", "conv_stem.cu", "conv_stem.py:160",
                  err, ms, plain_ms, bound, lib_ms, ok)


L2_BYTES = 50 * 2 ** 20


def _bound(nbytes, flops):
    """(bound ms, what bounds it) against the published H100 peaks."""
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def xattn_check(key, b, h=20, t=1500, dh=64, seed=30):
    """K4 (packed bf16) or K5 (int8 cross-KV) at the decode step's shapes
    against its plain version; the yardstick is SDPA on the same bf16 q,
    K and V in the (B, H, T, Dh) layout (K5: on K/V dequantized to bf16
    before timing, twice the bytes K5 reads), keys past the real ones
    masked. Timed back to back (the line's ``ms``) and alone in a CUDA
    graph, cold (each call on the next of enough K/V sets to pass the 50
    MB L2, as a decode step finds each layer's cross-KV) and over one set
    (in L2 where it fits); the line names the cluster size the kernel's
    plan chooses (the Python mirrors, tied to the source by
    tests/test_torch_k4_plan.py and tests/test_torch_k5_plan.py)."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import attention_pallas as ap
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + b)
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    if key == "K4":
        # K and V of the real positions, q read, out written (f32)
        nbytes = 2 * b * h * t * dh * 2 + b * h * dh * (2 + 4)
    else:
        # every position's int8 K and V and both scales (the mask is by
        # scale), q read, out written
        tp = -(-t // 128) * 128
        nbytes = b * h * tp * (2 * dh + 2 * 4) + b * h * dh * (2 + 4)
    sets = []
    for _ in range(max(1, -(-2 * L2_BYTES // nbytes))):
        k = torch.randn(1, b, h, t, dh, generator=g, device=dev)
        v = torch.randn(1, b, h, t, dh, generator=g, device=dev)
        if key == "K4":
            kd, vd = ap.pack_cross_kv_bf16((k, v))
            packed = {"kT": kd["kT"][0], "v": vd["v"][0]}
            mask = torch.arange(packed["kT"].shape[-1], device=dev)[None, :] < t
            sets.append((packed, packed["kT"].transpose(-1, -2).contiguous(),
                         packed["v"], mask))
        else:
            kq, vq = ap.quantize_cross_kv((k, v))
            kq = {z: w[0] for z, w in kq.items()}
            vq = {z: w[0] for z, w in vq.items()}
            kh = (kq["q"].float() * kq["s"][:, :, None, :]).transpose(
                -1, -2).to(torch.bfloat16).contiguous()
            vh = (vq["q"].float() * vq["s"][..., None]).to(torch.bfloat16)
            sets.append(((kq, vq), kh, vh, kq["s"][:, :, None, :] > 0))
        del k, v
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if key == "K4":
        call = lambda kv: ap.cross_attention_decode_bf16(q, kv, t)
        plain = lambda kv: ap.cross_attention_decode_bf16_plain(q, kv, t)
        tp = sets[0][0]["kT"].shape[-1]
        name, lib = "cross_attention_decode_bf16", "SDPA on bf16 q/k/v"
        c, sl = ap.k4_plan(b * h, tp, sms)
        plan = (f"; plan C={c} (slices of {sl} positions, {c * b * h} "
                f"blocks; a ring stage {ap.k4_rows(sl, dh)} rows of K or "
                f"{ap.k4_vbox(dh)} of V; ops/attention_pallas.py::k4_plan)")
    else:
        call = lambda kv: ap.cross_attention_decode_q8(q, *kv)
        plain = lambda kv: ap.cross_attention_decode_q8_plain(q, *kv)
        name = "cross_attention_decode_q8"
        lib = "SDPA on K/V dequantized to bf16 (2x K5's bytes)"
        c, sl = ap.k5_plan(b * h, tp, sms, dh)
        plan = (f"; plan C={c} (slices of {sl} positions, {c * b * h} "
                f"blocks; ops/attention_pallas.py::k5_plan)")
    kv0 = sets[0][0]
    got = call(kv0)
    torch.cuda.synchronize()
    ref = plain(kv0)
    diff = (got - ref).abs()
    err = diff.max().item()
    steps = (diff / (XATTN_STEP["atol"] + XATTN_STEP["rtol"]
                     * ref.abs())).max().item()
    finite = bool(torch.isfinite(got).all())
    same = bool(torch.equal(got, call(kv0)))
    sdpa = lambda z: F.scaled_dot_product_attention(
        q, z[1], z[2], attn_mask=z[3], scale=float(dh) ** -0.5)
    ms = cuda_ms(lambda: call(kv0), reps=50)
    # alone on the device: the calls captured in a CUDA graph, so that the
    # host does not pace them; over every set (cold) and over one (in L2
    # where it fits)
    n = len(sets)
    cold_ms = graph_ms(lambda: [call(z[0]) for z in sets], reps=20) / n
    warm_ms = graph_ms(lambda: call(kv0), reps=20)
    plain_ms = cuda_ms(lambda: plain(kv0), reps=10, warmup=2)
    lib_ms = cuda_ms(lambda: sdpa(sets[0]), reps=50)
    lib_cold = graph_ms(lambda: [sdpa(z) for z in sets], reps=20) / n
    lib_warm = graph_ms(lambda: sdpa(sets[0]), reps=20)
    bound, by = _bound(nbytes, 4.0 * b * h * t * dh)
    ok = finite and same and steps <= 1.0 and err < XATTN_TOL
    log(f"[kernel] {key} {name} B={b} H={h} Dh={dh} Tp={tp} t_real={t}: "
        f"max_abs_err {err:.3e} (ceiling {XATTN_TOL}), max |kernel - plain|"
        f" / (atol + rtol |plain|) {steps:.3f} (<= 1, {XATTN_STEP}) finite "
        f"{finite}, two calls bit for bit {same} -> "
        f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms back to back, "
        f"alone in a CUDA graph {cold_ms:.4f} cold ({n} K/V sets), "
        f"{warm_ms:.4f} over one set; plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}, {nbytes / 1e6:.2f} MB), {lib} {lib_ms:.4f} "
        f"ms back to back, alone {lib_cold:.4f} cold, {lib_warm:.4f} over "
        f"one set{plan}")
    return dict(name=name, route="cuda",
                source="nobs_whisper_torch/csrc/cross_attention_decode.cu",
                replaces=("nobs_whisper_tpu/ops/attention_pallas.py:189"
                          if key == "K4" else
                          "nobs_whisper_tpu/ops/attention_pallas.py:111"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, ok=ok)


def q8_check(m, k, n, x_dtype, what, seed=40, repeat=False):
    """K6 on one decoder weight shape against its plain version. Timed
    three ways: back-to-back calls of the wrapper (the line's ``ms``), the
    kernel alone on the device (the call captured in a CUDA graph, over
    enough weight sets to pass the 50 MB L2, as a decode step finds each
    weight in HBM), and the wrapper's host work a call (host clock over
    calls that enqueue without waiting). The yardstick is torch.matmul of
    bf16 x with the weight dequantized to bf16 before timing, back to back
    and alone. With ``repeat``, a second call must give the same bits."""
    import torch
    from nobs_whisper_torch.ops import quant as qt
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
    sets = max(1, -(-2 * L2_BYTES // (k * n)))
    ws = [qt.quantize_int8(torch.randn(k, n, generator=g, device=dev)
                           * k ** -0.5) for _ in range(sets)]
    w = ws[0]
    got = qt.q8_matmul(x, w)
    torch.cuda.synchronize()
    ref = qt.q8_matmul_plain(x, w)
    err = (got - ref).abs().max().item()
    close = bool(torch.allclose(got, ref, **K6_TOL))
    same = bool(torch.equal(got, qt.q8_matmul(x, w))) if repeat else True
    ms = cuda_ms(lambda: qt.q8_matmul(x, w), reps=50)
    device_ms = graph_ms(lambda: [qt.q8_matmul(x, wi) for wi in ws],
                         reps=20) / sets
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        qt.q8_matmul(x, w)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: qt.q8_matmul_plain(x, w), reps=10, warmup=2)
    xb = x.to(torch.bfloat16)
    wb = [wi["q"].to(torch.bfloat16) * wi["s"].to(torch.bfloat16)
          for wi in ws]
    lib_ms = cuda_ms(lambda: torch.matmul(xb, wb[0]), reps=50)
    lib_alone = graph_ms(lambda: [torch.matmul(xb, wi) for wi in wb],
                         reps=20) / sets
    del wb
    nbytes = k * n + n * 4 + m * k * x.element_size() + m * n * 4
    bound, by = _bound(nbytes, 2.0 * m * k * n)
    ok = close and same and bool(torch.isfinite(got).all())
    kernel = "decode" if m <= qt.K6_DECODE_ROWS else "prefill"
    log(f"[kernel] K6 q8_matmul {what} M={m} K={k} N={n} x {x_dtype} "
        f"({kernel} kernel): max_abs_err {err:.3e} ({K6_TOL})"
        + (f", two calls bit for bit {same}" if repeat else "")
        + f" -> {'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms back to "
        f"back, {device_ms:.4f} alone in a CUDA graph ({sets} weight sets), "
        f"the wrapper's host work {host_ms:.4f} ms a call; plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, {nbytes / 1e6:.2f} "
        f"MB), torch.matmul on bf16-dequantized weight {lib_ms:.4f} ms back "
        f"to back, {lib_alone:.4f} alone")
    return dict(name="q8_matmul", route="cuda",
                source="nobs_whisper_torch/csrc/q8_matmul.cu",
                replaces="nobs_whisper_tpu/ops/quant.py:73", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, ok=ok)


def decode_kernel_checks():
    """K4 at B=8, B=1 and B=16 and K5 at B=8 and B=1 (the line keeps B=8;
    every check must pass), K6 on the decoder's
    shapes (the line keeps the logit projection with f32 x, which the
    serving path runs, and two calls must give the same bits there; every
    check must pass). K6 also at the serving wave's prefill rows (3
    requests of an 8-token prompt, M = 24): the prefill kernel's 32-row
    instantiation with f32 x at the logit shape, and at fc2 (5120 x 1280),
    whose K split sums through the cluster, each giving the same bits
    twice."""
    import torch
    out = {}
    for key, more in (("K4", (1, 16)), ("K5", (1,))):
        e8 = xattn_check(key, b=8)
        for b in more:
            e8["ok"] &= xattn_check(key, b=b)["ok"]
        out[key] = e8
    logits = q8_check(8, 1280, 51866, torch.float32, "logits", repeat=True)
    ok = logits["ok"]
    for args in ((8, 1280, 51866, torch.bfloat16, "logits"),
                 (8, 1280, 5120, torch.bfloat16, "fc1"),
                 (8, 5120, 1280, torch.bfloat16, "fc2"),
                 (24, 1280, 51866, torch.float32, "logits", 40, True),
                 (24, 5120, 1280, torch.bfloat16, "fc2", 40, True),
                 (256, 1280, 51866, torch.bfloat16, "logits")):
        e = q8_check(*args)
        ok &= e["ok"]
        logits["max_abs_err"] = max(logits["max_abs_err"], e["max_abs_err"])
    logits["ok"] = ok
    out["K6"] = logits
    return out


# ---------------------------------------------------------------------------
# K14 and K7: ops that no serving path takes, checked and timed directly
# ---------------------------------------------------------------------------

def mel_pcm(b, seed=50):
    """(b, 480000) f32 PCM on the card: window i holds 5-29 s of
    speech-like bursts (seed + i), every third one over a tone, then zeros
    to 30 s."""
    import numpy as np
    import torch
    from nobs_whisper_torch.core.config import N_SAMPLES
    from nobs_whisper_torch.utils.testing import sine_audio, speech_like_audio
    out = np.zeros((b, N_SAMPLES), np.float32)
    for i in range(b):
        dur = 5.0 + (7 * i) % 25
        a = speech_like_audio(dur, seed=seed + i)
        if i % 3 == 0:
            a = a + sine_audio(dur, freq=220.0 + 40.0 * i)
        out[i, :a.size] = a
    return torch.from_numpy(out).cuda()


def k14_check(b, n_mels, timed=True):
    """K14 on b 30 s windows against its plain version (the raw log10
    above each sample's max - 8) and ``log_mel_spectrogram_pallas`` against
    the port's ``log_mel_spectrogram`` and the plain version (normalized);
    both scales also against the f64 oracle, which decides where the dense
    versions' own rounding is near the bounds. Yardsticks the port
    never calls: openai-whisper's formula in f32 with TF32 off
    (``torch.stft`` with a periodic hann window, centred, reflect-padded;
    ``|.|^2`` without the last frame; the filterbank matmul; log10); and
    the port's ``log_mel_spectrogram`` (cuBLAS SGEMM). The bound counts
    the function's work (a real FFT, the filterbank's nonzeros) against
    the PCM in, the mel out and the kernel's tables. Timed, the line gives
    the kernel's time three ways: back-to-back calls of the wrapper (the
    line's ``ms``), the kernel alone (``graph_ms``: the call captured in a
    CUDA graph), and the wrapper's host work per call (host clock over
    calls that enqueue without waiting)."""
    import math

    import numpy as np
    import torch
    from nobs_whisper_torch.audio.mel import (log_mel_spectrogram,
                                              mel_filter_bank)
    from nobs_whisper_torch.ops import mel_pallas as mp
    dev = torch.device("cuda")
    audio = mel_pcm(b)
    got = mp.log10_mel_pallas(audio, n_mels)
    torch.cuda.synchronize()
    ref = mp.log10_mel_pallas_plain(audio, n_mels)
    n_frames = ref.shape[1]
    keep = ref > torch.amax(ref, dim=(1, 2), keepdim=True) - 8.0
    raw_err = (got - ref).abs()[keep].max().item()
    finite = bool(torch.isfinite(got).all())
    norm = mp.log_mel_spectrogram_pallas(audio, n_mels)
    want = log_mel_spectrogram(audio, n_mels)
    norm_err = (norm - want).abs().max().item()
    # the same held to the plain version's normalized output, and the share
    # of raw values that differ at all (a vacuous comparison shows 0)
    plain_norm = ((torch.maximum(ref, torch.amax(ref, dim=(1, 2),
                                                 keepdim=True) - 8.0)
                   + 4.0) / 4.0).transpose(1, 2)
    plain_err = (norm - plain_norm).abs().max().item()
    differ = (got != ref)[keep].float().mean().item()
    # each against the f64 oracle on the host (its raw log10 is 4 n - 4
    # above the clamp): the plain version and the port's
    # log_mel_spectrogram are dense f32 DFTs with their own rounding
    from nobs_whisper_torch.audio.mel import log_mel_numpy_f64
    want64 = np.stack([log_mel_numpy_f64(a, n_mels)
                       for a in audio.cpu().numpy()])
    k14_64 = np.abs(norm.cpu().numpy() - want64).max()
    lms_64 = np.abs(want.cpu().numpy() - want64).max()
    raw64 = torch.from_numpy(4.0 * want64.transpose(0, 2, 1) - 4.0).to(dev)
    k14_raw64 = (got - raw64).abs()[keep].max().item()
    plain_raw64 = (ref - raw64).abs()[keep].max().item()
    oracle_ok = k14_64 <= K14_TOL and k14_raw64 <= 4 * K14_TOL
    oracle = (f", against the f64 oracle {k14_64:.3e} (tol {K14_TOL}; "
              f"log_mel_spectrogram {lms_64:.3e}); raw against the oracle "
              f"above max - 8: kernel {k14_raw64:.3e} (tol {4 * K14_TOL}), "
              f"plain {plain_raw64:.3e}")
    ok = (finite and raw_err <= 4 * K14_TOL and norm_err <= K14_TOL
          and plain_err <= K14_TOL and oracle_ok
          and tuple(norm.shape) == (b, n_mels, n_frames))
    # the function's operations, with a real FFT of the 400 taps (~2.5 N
    # log2 N): the window, the FFT, |.|^2 and the filterbank's nonzero
    # weights, each frame
    nnz = int(np.count_nonzero(mel_filter_bank(n_mels)))
    flops = b * n_frames * (400 + 2.5 * 400 * math.log2(400) + 3 * 201
                            + 2 * nnz)
    # PCM in and mel out, and the kernel's tables once (the FFT table, each
    # band's first and last bin and weight offset, the staged nonzero
    # filterbank weights)
    nbytes = (b * (audio.shape[1] + n_frames * n_mels) * 4
              + (mp.TAB_SIZE + 3 * n_mels + mp.MEL_MAX_NNZ) * 4)
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    bound, by = max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")
    line = (f"[kernel] K14 log10_mel_pallas B={b} 30 s windows n_mels="
            f"{n_mels}: raw max_abs_err above max - 8 {raw_err:.3e} (tol "
            f"{4 * K14_TOL}; {differ:.3f} of those values differ), "
            f"normalized against log_mel_spectrogram {norm_err:.3e} and "
            f"against the plain version {plain_err:.3e} (tol {K14_TOL})"
            f"{oracle}, finite {finite} -> {'PASS' if ok else 'FAIL'}")
    e = dict(name="log10_mel_pallas", route="cuda",
             source="nobs_whisper_torch/csrc/mel.cu",
             replaces="nobs_whisper_tpu/ops/mel_pallas.py:116",
             max_abs_err=raw_err, ms=None, plain_ms=None, bound_ms=bound,
             bound_by=by, library_ms=None, ok=ok)
    if timed:
        win = torch.hann_window(400, periodic=True, device=dev)
        melT = torch.from_numpy(mel_filter_bank(n_mels)).to(dev)

        def stft_mel():
            st = torch.stft(audio, 400, 160, window=win, center=True,
                            pad_mode="reflect", return_complex=True)
            p = st[..., :-1].abs() ** 2
            return torch.log10(torch.clamp(melT @ p, min=1e-10))

        call = lambda: mp.log10_mel_pallas(audio, n_mels)
        e["ms"] = cuda_ms(call, reps=10)
        device_ms = graph_ms(call, reps=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        e["plain_ms"] = cuda_ms(lambda: mp.log10_mel_pallas_plain(
            audio, n_mels), reps=5, warmup=1)
        e["library_ms"] = cuda_ms(stft_mel, reps=10)
        port_ms = cuda_ms(lambda: log_mel_spectrogram(audio, n_mels), reps=5,
                          warmup=1)
        line += (f"; kernel {e['ms']:.4f} ms back to back (alone in a CUDA "
                 f"graph {device_ms:.4f} ms; the wrapper's host work "
                 f"{host_ms:.4f} ms a call), plain {e['plain_ms']:.4f} ms, "
                 f"bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                 f"{flops / 1e9:.3f} GFLOP), torch.stft formula "
                 f"{e['library_ms']:.4f} ms, the port's log_mel_spectrogram "
                 f"(cuBLAS SGEMM) {port_ms:.4f} ms")
    log(line)
    return e


K7_SETS = 8   # weight sets a timed call cycles through: 105 MB of int8 > L2


def k7_check(m, x_dtype, d=1280, ffn=5120, seed=60):
    """K7 at turbo's decoder MLP against its plain version. K7 rounds the
    same bf16 operands at the same points in another f32 summation order,
    which can flip a bf16 element of the gelu output: bf16 x is held to one
    bf16 step elementwise (K1_STEP), f32 x to K6's 1e-3 absolute plus 1e-3
    relative. Times are device times (``graph_ms``) per call, each call on
    the next of ``K7_SETS`` weight sets so that the weights come from
    device memory, as in a decode step, not from L2. The yardstick:
    ``F.layer_norm``, ``torch.matmul`` on the weights dequantized to bf16
    beforehand (twice K7's weight bytes read), tanh ``F.gelu``,
    ``torch.matmul`` and the adds."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_int8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + m)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = rn(m, d).to(x_dtype)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    sets = [(quantize_int8(rn(d, ffn) * d ** -0.5), 0.1 * rn(ffn),
             quantize_int8(rn(ffn, d) * ffn ** -0.5), 0.1 * rn(d))
            for _ in range(K7_SETS)]
    args = (x, ln_g, ln_b, *sets[0])
    got = fm.fused_mlp_q8(*args)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_q8_plain(*args)
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    tol = K1_STEP if x_dtype == torch.bfloat16 else K6_TOL
    steps = (diff / (tol["atol"] + tol["rtol"] * ref.float().abs())
             ).max().item()
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and steps <= 1.0 and got.dtype == x_dtype
    each = lambda f: lambda: [f(x, ln_g, ln_b, *w) for w in sets]
    ms = graph_ms(each(fm.fused_mlp_q8)) / K7_SETS
    # fc2 by a plain stream-ordered launch, for comparison (PDL is K7's
    # default)
    fm.k7_set_pdl(False)
    try:
        nopdl_ms = graph_ms(each(fm.fused_mlp_q8)) / K7_SETS
    finally:
        fm.k7_set_pdl(True)
    plain_ms = graph_ms(each(fm.fused_mlp_q8_plain), reps=10) / K7_SETS
    eager_ms = cuda_ms(each(fm.fused_mlp_q8), reps=10) / K7_SETS
    deq = [(w1["q"].to(torch.bfloat16) * w1["s"].to(torch.bfloat16), b1,
            w2["q"].to(torch.bfloat16) * w2["s"].to(torch.bfloat16), b2)
           for w1, b1, w2, b2 in sets]

    def lib():
        for w1b, b1, w2b, b2 in deq:
            h = F.layer_norm(x.float(), (d,), ln_g, ln_b).to(torch.bfloat16)
            a = F.gelu(torch.matmul(h, w1b).float() + b1,
                       approximate="tanh").to(torch.bfloat16)
            (x.float() + torch.matmul(a, w2b).float() + b2).to(x.dtype)

    lib_ms = graph_ms(lib) / K7_SETS
    es = x.element_size()
    nbytes = (2 * d * ffn + 2 * (ffn + d) * 4 + 2 * d * 4
              + 2 * m * d * es)
    bound, by = _bound(nbytes, 2 * 2.0 * m * d * ffn)
    log(f"[kernel] K7 fused_mlp_q8 M={m} d={d} ffn={ffn} x {x_dtype}: "
        f"max_abs_err {err:.3e}, max |kernel - plain| / (atol + rtol "
        f"|plain|) {steps:.3f} (<= 1, {tol}) finite {finite} -> "
        f"{'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms (device, CUDA "
        f"graph, fc2 by programmatic dependent launch; {nopdl_ms:.4f} "
        f"without it; one eager call back to back {eager_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
        f"{nbytes / 1e6:.2f} MB), LN + matmuls on bf16-dequantized weights "
        f"{lib_ms:.4f} ms")
    return dict(name="fused_mlp_q8", route="cuda",
                source="nobs_whisper_torch/csrc/fused_mlp_q8.cu",
                replaces="nobs_whisper_tpu/ops/fused_mlp.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, ok=ok)


def k7_rows_ms(d=1280, ffn=5120, seed=60):
    """K7's device time (``graph_ms``, over the ``K7_SETS`` weight sets)
    at M = 1-8 bf16 rows. Its decode kernel runs every M <= 8 as one
    8-row tile of the tensor cores' n8 side, so equal times say that the
    rows cost nothing and the weight's stream is the time."""
    import torch
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_int8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    sets = [(quantize_int8(rn(d, ffn) * d ** -0.5), 0.1 * rn(ffn),
             quantize_int8(rn(ffn, d) * ffn ** -0.5), 0.1 * rn(d))
            for _ in range(K7_SETS)]
    times = {}
    for m in range(1, 9):
        x = rn(m, d).to(torch.bfloat16)
        times[m] = graph_ms(lambda: [fm.fused_mlp_q8(x, ln_g, ln_b, *w)
                                     for w in sets]) / K7_SETS
    log("[kernel] K7 by rows (bf16 x, d 1280, ffn 5120; one 8-row tile): "
        + ", ".join(f"M={m} {t:.4f} ms" for m, t in times.items()))


def op_kernel_checks():
    """K14 at B=40 30 s windows and 128 mels (the reference bench's
    ``--batch 40`` at turbo's mels; the line's numbers), checked also at
    B=1 and B=2 with 128 and 80 mels and at B=40 with 80; K7 at turbo's decoder
    MLP with M=8 and bf16 x (the line's), M=1 bf16 and M=1, 8 f32."""
    import torch
    out = {"K14": k14_check(40, 128)}
    for b, n_mels, timed in ((2, 128, True), (2, 80, False), (40, 80, False),
                             (1, 128, False), (1, 80, False)):
        _join(out, "K14", k14_check(b, n_mels, timed))
        torch.cuda.empty_cache()
    out["K7"] = k7_check(8, torch.bfloat16)
    for m, xd in ((1, torch.bfloat16), (1, torch.float32),
                  (8, torch.float32)):
        _join(out, "K7", k7_check(m, xd))
    k7_rows_ms()
    return out


def attention_kernel_check(key, name, replaces, b, h, t, dh, n_real):
    """K3 (flat (B, T, H dh)) or K9 ((B, H, T, dh)) against its plain
    version on random bf16 q/k/v; the library yardstick is SDPA on the
    same q/k/v in the (B, H, T, dh) view, keys >= n_real masked."""
    import torch
    import torch.nn.functional as F
    from nobs_whisper_torch.ops import encoder_attention as ea
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(t + h + dh)
    shape = (b, t, h * dh) if key == "K3" else (b, h, t, dh)
    q, k, v = ((torch.randn(*shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(3))
    sm = float(dh) ** -0.5
    if key == "K3":
        fn = lambda: ea.encoder_attention_btd(q, k, v, n_real, sm, h)
        plain = lambda: ea.encoder_attention_btd_plain(q, k, v, n_real, sm, h)
        heads = lambda z: z.view(b, t, h, dh).transpose(1, 2)
        real = (slice(None), slice(0, n_real))
    else:
        fn = lambda: ea.encoder_attention(q, k, v, n_real, sm)
        plain = lambda: ea.encoder_attention_plain(q, k, v, n_real, sm)
        heads = lambda z: z
        real = (Ellipsis, slice(0, n_real), slice(None))
    got = fn()
    torch.cuda.synchronize()
    ref = plain()
    finite = bool(torch.isfinite(got.float()).all())
    diff = (got.float() - ref.float())[real].abs()
    err = diff.max().item()
    steps = (diff / (ATTN_STEP["atol"] + ATTN_STEP["rtol"]
                     * ref.float()[real].abs())).max().item()
    del diff, ref
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    mask = torch.zeros(1, t, device=dev, dtype=torch.bool)
    mask[:, :n_real] = True          # (1, S): keys >= n_real masked
    qh, kh, vh = heads(q), heads(k), heads(v)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=sm))
    flops = 4.0 * b * h * t * n_real * dh      # QK^T and PV over real keys
    nbytes = 4 * b * t * h * dh * 2            # q, k, v read, out written
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES \
        else "bytes"
    ok = finite and steps <= 1.0 and err < ATTN_TOL
    log(f"[kernel] {key} {name} B={b} T={t} H={h} dh={dh} n_real={n_real}: "
        f"max_abs_err {err:.3e} (ceiling {ATTN_TOL}), max |kernel - plain| "
        f"/ (atol + rtol |plain|) {steps:.3f} (<= 1, {ATTN_STEP}) finite "
        f"{finite} -> {'PASS' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), SDPA {lib_ms:.4f} "
        f"ms")
    return dict(name=name, route="cuda",
                source="nobs_whisper_torch/csrc/encoder_attention.cu",
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, ok=ok)


GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "goldens", "oracle_tiny.npz")
GOLDEN_XA_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_goldens.py's bounds
ENC_TOL = 5e-2    # tests/test_torch_kernels_gpu.py: int8 encoder, 2 layers


def _load_goldens(dev):
    """The repo's oracle goldens (params, mel, xa, prompt, greedy tokens)
    as a torch parameter tree on ``dev``; no JAX needed."""
    import re
    import numpy as np
    from nobs_whisper_torch.core.config import WhisperConfig
    from nobs_whisper_torch.models import whisper as mw
    z = np.load(GOLDENS)
    params = {}
    for key in z.files:
        if not key.startswith("params["):
            continue
        path = re.findall(r"\['([^']+)'\]", key)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = z[key]
    cfg = WhisperConfig(name="goldens-tiny", force_multilingual=True,
                        **json.loads(bytes(z["cfg_json"]).decode()))
    return z, mw.params_from_jax(params, device=dev), cfg


def phase_reference():
    """Small inputs against references, on the card:

    * the f32 float path (no kernels) against the oracle goldens: encoder
      states within the golden tests' bounds, greedy tokens equal;
    * encoders at a dh=64 width on the card against the same encoders'
      plain versions on the CPU: int8 at bf16 (K1, K2), float at bf16
      (K3), int8 at f32 (K2's f32 variant)."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    dev = torch.device("cuda")

    z, params, cfg = _load_goldens(dev)
    xa = mw.encode(params, torch.from_numpy(z["mel"]).to(dev), cfg)
    xa_ok = np.allclose(xa.cpu().numpy(), z["xa"], **GOLDEN_XA_TOL)
    xa_err = float(np.abs(xa.cpu().numpy() - z["xa"]).max())
    opts = DecodeOptions(suppress_blank=True)
    res = decode_window(params, torch.from_numpy(z["xa"]).to(dev),
                        [z["prompt"].tolist()], cfg,
                        build_rule_tables(cfg, opts), opts)[0]
    want = z["greedy_tokens"].tolist()
    tok_ok = res.tokens == want
    log(f"[reference] f32 path vs oracle goldens: encoder max_abs_err "
        f"{xa_err:.3e} ({GOLDEN_XA_TOL}) -> {'PASS' if xa_ok else 'FAIL'}; "
        f"greedy tokens {len(res.tokens)} equal {tok_ok} -> "
        f"{'PASS' if tok_ok else 'FAIL'}")

    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    qp = quantize_encoder_params(mw.init_params(3, cfg, dtype=torch.bfloat16))
    mel = torch.from_numpy(
        np.random.RandomState(4).randn(2, cfg.n_mels, 64).astype(np.float32))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    k1, k2 = ea.launch_count, fm.launch_count
    got = mw.encode(to_dev(qp), mel.to(dev), cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    through = (ea.launch_count - k1, fm.launch_count - k2) == \
        (cfg.n_audio_layer, cfg.n_audio_layer)
    ref = mw.encode(qp, mel, cfg, compute_dtype=torch.bfloat16)
    err = (got.float().cpu() - ref.float()).abs().max().item()
    enc_ok = through and bool(torch.isfinite(got.float()).all()) \
        and err < ENC_TOL
    log(f"[reference] int8 encoder d=128 dh=64 card (K1, K2) vs CPU plain: "
        f"max_abs_err {err:.3e} (tol {ENC_TOL}), kernels launched per layer "
        f"{through} -> {'PASS' if enc_ok else 'FAIL'}")

    # the float encoder at bf16 (K3 once per layer), and the int8 encoder
    # at f32 compute (the reference's TPU gate: K2's f32 variant, no
    # attention kernel), each against its CPU run
    fp = mw.init_params(3, cfg, dtype=torch.bfloat16)
    k3 = ea.k3_launch_count
    got = mw.encode(to_dev(fp), mel.to(dev), cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    through = ea.k3_launch_count - k3 == cfg.n_audio_layer
    ref = mw.encode(fp, mel, cfg, compute_dtype=torch.bfloat16)
    err = (got.float().cpu() - ref.float()).abs().max().item()
    k3_ok = through and bool(torch.isfinite(got.float()).all()) \
        and err < ENC_TOL
    log(f"[reference] float encoder d=128 dh=64 bf16 card (K3) vs CPU plain: "
        f"max_abs_err {err:.3e} (tol {ENC_TOL}), K3 launched per layer "
        f"{through} -> {'PASS' if k3_ok else 'FAIL'}")

    qp32 = quantize_encoder_params(mw.init_params(3, cfg))
    k1, k2f = ea.launch_count, fm.launch_count_f32
    got = mw.encode(to_dev(qp32), mel.to(dev), cfg)
    torch.cuda.synchronize()
    through = (ea.launch_count - k1, fm.launch_count_f32 - k2f) == \
        (0, cfg.n_audio_layer)
    ref = mw.encode(qp32, mel, cfg)
    err = (got.cpu() - ref).abs().max().item()
    f32_ok = through and got.dtype == torch.float32 \
        and bool(torch.isfinite(got).all()) and err < ENC_TOL
    log(f"[reference] int8 encoder d=128 dh=64 f32 card (K2 f32, no K1) vs "
        f"CPU plain: max_abs_err {err:.3e} (tol {ENC_TOL}), launches per "
        f"layer {through} -> {'PASS' if f32_ok else 'FAIL'}")
    with knobs(SLICE_KNOBS):
        slice_ok = reference_knob_slice(dev, cfg, mel, to_dev)
    var_ok = reference_variants(dev, cfg, mel, to_dev)
    with knobs(DECODE_KNOBS):
        dec_ok = reference_decoder(dev)
    return (xa_ok and tok_ok and enc_ok and k3_ok and f32_ok and slice_ok
            and var_ok and dec_ok and reference_beam(dev)
            and reference_speculative(dev))


BEAM_GOLDEN_TOL = dict(rel=1e-3, abs=1e-3)   # tests/test_goldens.py's bound


def reference_beam(dev):
    """Beam search on small models on the card: the tiny f32 golden model
    gives the golden ``beam_tokens`` (beam 5, 40 steps) and its
    ``beam_sum_logprob`` within 1e-3 relative + 1e-3 absolute, with and
    without ``NWT_BEAM_ANCESTRY``; a d=128 dh=64 int8 model at f32 gives
    the CPU's beam tokens on three windows."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.beam import beam_decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    z, params, cfg = _load_goldens(dev)
    tables = build_rule_tables(cfg, DecodeOptions(suppress_blank=True))
    want = z["beam_tokens"].tolist()
    want_sum = float(z["beam_sum_logprob"])
    ok = True
    for anc in (False, True):
        with knobs(("NWT_BEAM_ANCESTRY",) if anc else ()):
            res = beam_decode_window(params, torch.from_numpy(z["xa"]).to(dev),
                                     [z["prompt"].tolist()], cfg, tables,
                                     beam_size=5, sample_len=40)[0]
        err = abs(res.sum_logprob - want_sum)
        this = res.tokens == want and err <= (
            BEAM_GOLDEN_TOL["abs"] + BEAM_GOLDEN_TOL["rel"] * abs(want_sum))
        log(f"[reference] beam 5 on the f32 golden model"
            f"{' under NWT_BEAM_ANCESTRY=1' if anc else ''}: tokens "
            f"{len(res.tokens)} equal the golden's {res.tokens == want}, "
            f"sum_logprob {res.sum_logprob:.5f} vs {want_sum:.5f} (|diff| "
            f"{err:.2e}, {BEAM_GOLDEN_TOL}) -> {'PASS' if this else 'FAIL'}")
        ok &= this

    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=160, n_text_ctx=64)
    params = quantize_decoder_params(mw.init_params(DEC_SEED, cfg))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    xa = torch.from_numpy(np.random.RandomState(6).randn(
        3, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    prompts = [[cfg.sot, cfg.lang_base + i, cfg.transcribe]
               for i in range(3)]
    tables = build_rule_tables(cfg, DecodeOptions())
    got = beam_decode_window(to_dev(params), xa.to(dev), prompts, cfg,
                             tables, beam_size=5)
    ref = beam_decode_window(params, xa, prompts, cfg, tables, beam_size=5)
    same = [r.tokens for r in got] == [r.tokens for r in ref]
    log(f"[reference] beam 5 on a d=128 dh=64 int8 model at f32, three "
        f"windows, card vs CPU: tokens {[len(r.tokens) for r in got]} equal "
        f"{same} -> {'PASS' if same else 'FAIL'}")
    return ok and same


def reference_knob_slice(dev, cfg, mel, to_dev):
    """The d=128 dh=64 int8 encoder with the slice's three knobs on, on
    the card against the same model's plain run on the CPU: at bf16 K13
    once, then K10, K9, K11 and K8 once a layer; at f32 K10, K11 and K8
    (f32 variants) once a layer, no attention kernel and no K13."""
    import torch
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    n = cfg.n_audio_layer
    ok = True
    for dt in (torch.bfloat16, torch.float32):
        qp = quantize_encoder_params(mw.init_params(3, cfg, dtype=dt))
        reset_counts()
        got = mw.encode(to_dev(qp), mel.to(dev), cfg, compute_dtype=dt)
        torch.cuda.synchronize()
        c = read_counts()
        if dt == torch.bfloat16:
            want = dict(K13=1, K10=n, K9=n, K11=n, K8=n)
        else:
            want = {"K10-f32": n, "K11-f32": n, "K8-f32": n, "K13": 0,
                    "K9": 0}
        through = all(c[k] == v for k, v in want.items()) and \
            c["K1"] == c["K2"] == c["K3"] == 0 and no_op_kernels(c)
        ref = mw.encode(qp, mel, cfg, compute_dtype=dt)
        err = (got.float().cpu() - ref.float()).abs().max().item()
        this = through and bool(torch.isfinite(got.float()).all()) \
            and err < ENC_TOL and got.dtype == dt
        log(f"[reference] int8 encoder d=128 dh=64 {str(dt)[6:]} with "
            f"{' '.join(SLICE_KNOBS)}, card vs CPU plain: max_abs_err "
            f"{err:.3e} (tol {ENC_TOL}); launches {_launch_summary(c)} "
            f"(want {want}, K1 = K2 = K3 = 0) -> "
            f"{'PASS' if this else 'FAIL'}")
        ok &= this
    return ok


DEC_LOGIT_TOL = 5e-2   # bf16 decoder, 2 layers: see reference_decoder


class knobs:
    """Set environment knobs in-process, each of ``names`` to "1" and each
    of ``values`` to its value; restore them on exit."""

    def __init__(self, names=(), **values):
        self.values = {**{k: "1" for k in names}, **values}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


DEC_SEED = 6


def reference_decoder(dev):
    """A d=128 dh=64 int8 decoder (and its tiny logit projection, N=1000)
    with the three decode knobs on, on the card against the same model's
    plain run on the CPU:

    * f32 compute, int8 cross-KV (K5, K6) and the packed layout (K4, K6):
      greedy tokens equal, and the launches what the gates predict;
    * int8 cross-KV at f32 and at bf16 compute: the prefill logits (K6
      alone: more than one token) and the next single-token forward's (K5
      and K6) within 5e-2 of the CPU's. The two runs share every rounding
      rule, but K5 and K6 round their inputs to bf16 as the TPU kernels
      do, also at f32 compute, so an f32 summation-order difference
      upstream can become a bf16 step (2^-8 relative) of one input, which
      moves a logit of order 1 by about 1e-2.

    Greedy tokens follow the logits only where no two choices are that
    close: on weight seed 5 one of the three int8 cross-KV windows
    diverged between card and CPU; seed 6 is the model here."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=160, n_text_ctx=64)
    params = quantize_decoder_params(mw.init_params(DEC_SEED, cfg))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    xa = torch.from_numpy(np.random.RandomState(6).randn(
        3, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    prompts = [[cfg.sot, cfg.lang_base + i, cfg.transcribe]
               for i in range(3)]
    ok = True
    for opts in (DecodeOptions(q8_cross_kv=True),
                 DecodeOptions(xattn_bf16=True)):
        tables = build_rule_tables(cfg, opts)
        reset_counts()
        got = decode_window(to_dev(params), xa.to(dev), prompts, cfg,
                            tables, opts)
        torch.cuda.synchronize()
        c = read_counts()
        want = predicted_decode_launches(c["forwards"], cfg.n_text_layer)
        ref = decode_window(params, xa, prompts, cfg, tables, opts)
        same = [r.tokens for r in got] == [r.tokens for r in ref]
        first = [next((i for i, (a, b) in enumerate(zip(g.tokens, r.tokens))
                       if a != b), None) for g, r in zip(got, ref)]
        counts_ok = all(c[k] == want[k] for k in want) and c["K6"] > 0 \
            and no_op_kernels(c)
        layout = "q8" if opts.q8_cross_kv else "packed"
        log(f"[reference] int8 decoder d=128 dh=64 f32 {layout} cross-KV, "
            f"knobs on, card vs CPU plain: greedy tokens "
            f"{[len(r.tokens) for r in got]} equal {same} (first "
            f"difference by window {first}); launches "
            f"K4 {c['K4']} K5 {c['K5']} K6 {c['K6']} (want {want}) -> "
            f"{'PASS' if same and counts_ok else 'FAIL'}")
        ok &= same and counts_ok

    # prefill and one step on int8 cross-KV, both packages' compute dtypes
    for dt in (torch.float32, torch.bfloat16):
        p = quantize_decoder_params(mw.init_params(DEC_SEED, cfg, dtype=dt))
        logits = []
        for pp, x in ((to_dev(p), xa.to(dev, dt)), (p, xa.to(dt))):
            cross = mw.precompute_cross_kv_q8(pp, x, cfg)
            cache = mw.init_kv_cache(cfg, 3, dtype=dt, t_ctx=16,
                                     device=x.device)
            toks = torch.tensor([[cfg.eot] * 5 + q for q in prompts],
                                device=x.device)
            pad = torch.full((3,), 5, device=x.device)
            pre, cache = mw.decoder_forward(pp, toks, 0, pad, cache, cross,
                                            cfg, dt)
            # the same next token on both sides: the CPU's would do as well
            nxt = torch.full((3, 1), cfg.sot, device=x.device)
            step, _ = mw.decoder_forward(pp, nxt, 8, pad, cache, cross, cfg,
                                         dt)
            logits.append((pre.float().cpu(), step.float().cpu()))
        (pc, sc_), (pr, sr) = logits
        e_pre = (pc - pr).abs().max().item()
        e_step = (sc_ - sr).abs().max().item()
        lg_ok = (e_pre < DEC_LOGIT_TOL and e_step < DEC_LOGIT_TOL
                 and bool(torch.isfinite(pc).all()
                          and torch.isfinite(sc_).all()))
        log(f"[reference] int8 decoder d=128 dh=64 {str(dt)[6:]} int8 "
            f"cross-KV, knobs on, card vs CPU plain: prefill logits "
            f"max_abs_err {e_pre:.3e}, step logits {e_step:.3e} (tol "
            f"{DEC_LOGIT_TOL}, logits up to {pr.abs().max().item():.2f}) -> "
            f"{'PASS' if lg_ok else 'FAIL'}")
        ok &= lg_ok
    return ok


def predicted_decode_launches(forwards, n_layer):
    """K4, K5 and K6 launches the gates predict for the decoder forwards
    run (``models/whisper.py::decoder_forward_calls``, by cross-KV layout,
    batch and tokens), with every knob on and K6's threshold at 1 byte: K4
    or K5 once a layer in a single-token forward on the packed or int8
    cross-KV; K6 on the 8 int8 weights of each layer and the logit
    projection in a forward of at most 256 rows, "K6-decode" those of at
    most ``K6_DECODE_ROWS`` (16) rows (its decode kernel). (The cross-KV
    projection has B x 1500 rows at full size, B x 160 in the reference
    phase: no K6 there.)"""
    from nobs_whisper_torch.ops import quant as qt
    n = lambda pred: sum(c for key, c in forwards.items() if pred(*key))
    return {"K4": n_layer * n(lambda lay, b, s: lay == "packed" and s == 1),
            "K5": n_layer * n(lambda lay, b, s: lay == "q8" and s == 1),
            "K6": (8 * n_layer + 1) * n(lambda lay, b, s: b * s <= 256),
            "K6-decode": (8 * n_layer + 1) * n(
                lambda lay, b, s: b * s <= qt.K6_DECODE_ROWS)}


def _request_audio():
    """Wave 1: five concurrent requests, one of them auto-language (the
    batch then runs encode + language detection, then decode); wave 2: two
    fixed-language requests (the one-program frames -> decode path)."""
    from nobs_whisper_torch.utils.testing import sine_audio, speech_like_audio
    return [
        ("en-5s", speech_like_audio(5.0, seed=1), "en"),
        ("en-12s", speech_like_audio(12.0, seed=2), "en"),
        ("en-18s", sine_audio(18.0, freq=330.0) +
         speech_like_audio(18.0, seed=3), "en"),
        ("en-25s", speech_like_audio(25.0, seed=4), "en"),
        ("auto-8s", speech_like_audio(8.0, seed=5), None),
    ], [
        ("en-10s", speech_like_audio(10.0, seed=6), "en"),
        ("en-20s", speech_like_audio(20.0, seed=7), "en"),
    ]


def _run_wave(be, wave, card):
    import math
    results, errors = {}, []

    def one(name, audio, lang):
        t0 = time.perf_counter()
        try:
            r = be.transcribe(audio, language=lang)
            results[name] = (r, time.perf_counter() - t0, len(audio) / 16000)
        except Exception as e:  # reported below, fails the phase
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=one, args=w) for w in wave]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ok = not errors and len(results) == len(wave)
    for name, err in errors:
        log(f"[serve] {name}: FAILED {err}")
    for name, (r, dt, dur) in sorted(results.items()):
        toks = sum(len(s.tokens) for s in r.segments)
        finite = all(math.isfinite(s.avg_logprob)
                     and math.isfinite(s.no_speech_prob) for s in r.segments)
        ok &= finite and isinstance(r.text, str)
        log(f"[serve] {card}: {name} ({dur:.1f} s audio) latency "
            f"{dt * 1e3:.1f} ms, tokens {toks}, segments "
            f"{len(r.segments)}, language {r.language}, finite {finite}")
    return ok


def phase_serving(card, eng):
    """``eng``: the large-v3-turbo engine's ``quantize()`` (int8 encoder
    and decoder)."""
    import torch
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = eng.cfg
    be = BatchedEngine(eng, max_batch=8)
    wave1, wave2 = _request_audio()
    try:
        reset_counts()
        t0 = time.perf_counter()
        ok = _run_wave(be, wave1, card)
        ok &= _run_wave(be, wave2, card)
        ok &= _run_wave(be, [("longform-45s", speech_like_audio(
            45.0, seed=8), "en")], card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        launches = {"K1": c["K1"], "K2": c["K2"]}
        batches = c["batches"]
        want = cfg.n_audio_layer * batches
        counts_ok = (batches > 0 and launches["K1"] == want
                     and launches["K2"] == want
                     and c["K3"] == c["K9"] == c["K2-f32"] == 0
                     and c["K4"] == c["K5"] == c["K6"] == 0
                     and no_knob_kernels(c))
        log(f"[serve] {card}: wall {wall:.2f} s; batch sizes "
            f"{be.batcher.batch_sizes}; encoder batches {batches}; "
            f"launches K1 {launches['K1']} K2 {launches['K2']} "
            f"(want {cfg.n_audio_layer} x {batches} = {want}) -> "
            f"{'PASS' if counts_ok else 'FAIL'}")
        ok &= counts_ok
        # one request of wave 1 again, the same one the int8 cross-KV
        # phase profiles, so that the two profiles compare request for
        # request; its wall is the greedy rung that [beam] sets beside
        # its own
        GREEDY_RUNG["wall"] = profile_wave(be, [wave1[1]], card)
    finally:
        be.close()
    return ok, launches


# the profiled greedy rung of [serve] (one 12 s window, 224 steps at B=1)
GREEDY_RUNG = {}


# the hand-written kernels an encoder batch launches (K1, K2 and every
# variant's pieces; csrc/), for the profile's encoder share; a kernel
# counts where one of these is part of its name
ENCODER_CSRC_KERNELS = (
    "attn_wgmma_kernel", "ln_quant_kernel", "mlp_fc1_", "mlp_fc2_kernel",
    "requant_kernel", "i8_stats_kernel", "i8_quant_kv_kernel",
    "stem_mel_rows_kernel", "stem_conv_kernel", "proj_wgmma_kernel")


def profile_wave(be, wave, card):
    """One more concurrent wave under torch.profiler: device time by
    kernel, the device's idle share of the wave's wall time, and the
    device time of dtype copies (``copy`` kernels: on the int8 decoder's
    default path, the per-step dequantization of every weight). The wave
    runs on a batcher of its own over ``be``'s engine and options with one
    greedy rung per window (224 decode steps; random weights never emit
    eot, so the six-rung ladder would repeat them six times, and the
    trace's processing takes minutes per rung). Outside the counted run;
    a profiler failure is reported, not fatal. Returns the wave's wall
    (None if not measured)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    one = BatchedEngine(be.engine, max_batch=8, opts=dataclasses.replace(
        be.opts, temperature_increment=0.0))
    try:
        with profile(activities=acts) as prof:
            # the wave's own wall: not the profiler's start (seconds the
            # first time) nor the trace's processing at exit
            t0 = time.perf_counter()
            _run_wave(one, wave, card)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        rows = sorted(ka, key=lambda e: -getattr(e, attr))
        busy_s = sum(getattr(e, attr) for e in ka) / 1e6
    except Exception as e:
        log(f"[profile] not measured: {e!r}")
        return None
    finally:
        one.close()
    copy_ms = sum(getattr(e, attr) for e in ka if "copy" in e.key) / 1e3
    top_copies = sum("copy" in e.key for e in rows[:15])
    log(f"[profile] {card}: profiled wave wall {wall:.3f} s, device busy "
        f"{busy_s:.3f} s (self device time summed), idle share "
        f"{max(0.0, 1 - busy_s / wall):.3f}; dtype-copy kernels "
        f"{copy_ms:.2f} ms device time, {top_copies} of the 15 largest rows")
    enc = [e for e in ka if any(k in e.key for k in ENCODER_CSRC_KERNELS)]
    enc_ms = sum(getattr(e, attr) for e in enc) / 1e3
    attn_ms = sum(getattr(e, attr) for e in enc
                  if "attn_wgmma" in e.key) / 1e3
    log(f"[profile] {card}: the encoder's CUDA kernels {enc_ms:.2f} ms device "
        f"time, {enc_ms / 1e3 / busy_s:.3f} of busy; of it the attention "
        f"core {attn_ms:.2f} ms")
    for e in rows[:15]:
        t = getattr(e, attr)
        if t <= 0:
            break
        log(f"[profile]   {t / 1e3:10.2f} ms  {e.count:7d}x  {e.key[:90]}")
    return wall


def reset_counts():
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import conv_stem as cs
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import fused_qkv as fq
    from nobs_whisper_torch.ops import mel_pallas as mp
    from nobs_whisper_torch.ops import quant as qt
    ea.launch_count = ea.k3_launch_count = ea.k9_launch_count = 0
    fm.launch_count = fm.launch_count_f32 = 0
    fm.k8_launch_count = fm.k8_launch_count_f32 = 0
    fq.k10_launch_count = fq.k10_launch_count_f32 = 0
    fq.k11_launch_count = fq.k11_launch_count_f32 = 0
    cs.launch_count = 0
    ap.k4_launch_count = ap.k5_launch_count = qt.k6_launch_count = 0
    qt.k6_decode_launch_count = 0
    ea.variant_launch_count.clear()
    fl.launch_count = 0
    fl.variant_launch_count.clear()
    fm.k7_launch_count = mp.k14_launch_count = 0
    mw.encode_count = 0
    mw.decoder_forward_calls.clear()


def read_counts():
    """Launches of each kernel since :func:`reset_counts`; "K2", "K8",
    "K10" and "K11" count both activation types, "*-f32" the f32 ones;
    "K1" and "K3" their default variants, the others by variant name
    ("K1-o", "K3-i8s-i8pv", "K12", ...)."""
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import conv_stem as cs
    from nobs_whisper_torch.ops import encoder_attention as ea
    from nobs_whisper_torch.ops import fused_layer as fl
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import fused_qkv as fq
    from nobs_whisper_torch.ops import mel_pallas as mp
    from nobs_whisper_torch.ops import quant as qt
    return {"K1": ea.launch_count, "K3": ea.k3_launch_count,
            "K9": ea.k9_launch_count, "K2": fm.launch_count,
            "K2-f32": fm.launch_count_f32, "K8": fm.k8_launch_count,
            "K8-f32": fm.k8_launch_count_f32, "K10": fq.k10_launch_count,
            "K10-f32": fq.k10_launch_count_f32,
            "K11": fq.k11_launch_count, "K11-f32": fq.k11_launch_count_f32,
            "K13": cs.launch_count, "K4": ap.k4_launch_count,
            "K5": ap.k5_launch_count, "K6": qt.k6_launch_count,
            "K6-decode": qt.k6_decode_launch_count,
            **{n: ea.variant_launch_count[n] + fl.variant_launch_count[n]
               for n in variant_names()},
            "K12": fl.launch_count,
            "K7": fm.k7_launch_count, "K14": mp.k14_launch_count,
            "batches": mw.encode_count,
            "forwards": dict(mw.decoder_forward_calls)}


def no_op_kernels(c):
    """K7 and K14 launch on no serving, transcribe or reference path."""
    return not any(c[k] for k in OP_KERNELS)


def no_knob_kernels(c):
    """With no encoder knob set, K8, K10, K11, K13, K12 and the variants
    of K1 and K3 never launch, nor do K7 and K14."""
    return no_op_kernels(c) and not any(
        c[k] for k in KNOB_KERNELS + tuple(variant_names()))


def _launch_summary(c):
    """The counts that are not 0 (the rest are 0), batches included."""
    return {k: v for k, v in c.items() if k != "forwards" and v}


def _transcribe_one(eng, name, audio, card, opts):
    import math
    t0 = time.perf_counter()
    r = eng.transcribe(audio, language="en", opts=opts)
    dt = time.perf_counter() - t0
    toks = sum(len(s.tokens) for s in r.segments)
    ok = isinstance(r.text, str) and all(
        math.isfinite(s.avg_logprob) and math.isfinite(s.no_speech_prob)
        for s in r.segments)
    log(f"[transcribe] {card}: {name} ({len(audio) / 16000:.1f} s audio) "
        f"latency {dt * 1e3:.1f} ms, tokens {toks}, segments "
        f"{len(r.segments)}, finite {ok}")
    return ok


def phase_transcribe(card, eng):
    """The JAX package's default file path (``cli transcribe``): ``eng``,
    the unquantized large-v3-turbo engine at bf16 compute. Counts are set
    to 0 just before each path and read just after it."""
    import dataclasses
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import speech_like_audio

    # random weights never emit eot: one greedy rung per window (224
    # steps) instead of the 6-rung temperature ladder
    opts = DecodeOptions(temperature_increment=0.0)
    cfg = eng.cfg

    # K3: heads pair (dh = 64)
    reset_counts()
    ok = _transcribe_one(eng, "en-12s", speech_like_audio(12.0, seed=21),
                         card, opts)
    ok &= _transcribe_one(eng, "longform-45s",
                          speech_like_audio(45.0, seed=22), card, opts)
    ok &= _transcribe_one(eng.with_audio_ctx(750), "audio_ctx750-10s",
                          speech_like_audio(10.0, seed=23), card, opts)
    torch.cuda.synchronize()
    c = read_counts()
    want = cfg.n_audio_layer * c["batches"]
    k3_ok = c["batches"] > 0 and c["K3"] == want and no_knob_kernels(c) \
        and c["K1"] == c["K9"] == c["K2"] == c["K4"] == c["K5"] == c["K6"] == 0
    log(f"[transcribe] {card}: encoder batches {c['batches']}; launches "
        f"{_launch_summary(c)} (want K3 = {cfg.n_audio_layer} x "
        f"{c['batches']} = {want}, others 0) -> "
        f"{'PASS' if k3_ok else 'FAIL'}")
    launches = {"K3": c["K3"]}

    # K9: the same weights split into heads of 128 (10 at turbo width),
    # which do not pair into 128 lanes (the decoder's heads too: the
    # packages derive one head width from the config)
    h128 = cfg.n_audio_state // 128
    eng10 = dataclasses.replace(eng, cfg=dataclasses.replace(
        cfg, n_audio_head=h128, n_text_head=h128))
    reset_counts()
    ok &= _transcribe_one(eng10, "heads10-12s",
                          speech_like_audio(12.0, seed=24), card, opts)
    torch.cuda.synchronize()
    c = read_counts()
    want = cfg.n_audio_layer * c["batches"]
    k9_ok = c["batches"] > 0 and c["K9"] == want and no_knob_kernels(c) \
        and c["K1"] == c["K3"] == c["K4"] == c["K5"] == c["K6"] == 0
    log(f"[transcribe] {card}: 10 heads of 128: launches "
        f"{_launch_summary(c)} (want K9 = {cfg.n_audio_layer} x "
        f"{c['batches']} = {want}) -> {'PASS' if k9_ok else 'FAIL'}")
    launches["K9"] = c["K9"]

    # the int8 encoder at f32 compute: one batch at full width
    enc32 = {"encoder": {k: (v.float() if torch.is_tensor(v) else
                             {kk: vv.float() for kk, vv in v.items()})
                         for k, v in eng.params["encoder"].items()}}
    enc32 = quantize_encoder_params(enc32)
    del eng10
    torch.cuda.empty_cache()
    mel = torch.from_numpy(np.random.RandomState(25).randn(
        1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)).cuda()
    reset_counts()
    xa = mw.encode(enc32, mel, cfg, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    c = read_counts()
    f32_ok = (c["K2-f32"] == c["K2"] == cfg.n_audio_layer and c["K1"] == 0
              and no_knob_kernels(c) and xa.dtype == torch.float32
              and tuple(xa.shape) == (1, cfg.n_audio_ctx, cfg.n_audio_state)
              and bool(torch.isfinite(xa).all()))
    log(f"[transcribe] {card}: int8 encoder at f32, one batch: launches "
        f"{_launch_summary(c)} (want K2-f32 = K2 = {cfg.n_audio_layer}, "
        f"K1 = 0), states "
        f"{tuple(xa.shape)} finite -> {'PASS' if f32_ok else 'FAIL'}")
    launches["K2-f32"] = c["K2-f32"]
    del enc32, xa
    torch.cuda.empty_cache()
    return ok and k3_ok and k9_ok and f32_ok and phase_cli(card), launches


def phase_decode_kernels(card, qeng, eng):
    """The decode-step kernels on their paths, the knobs set in-process
    around each and restored after; counts set to 0 just before each path
    and read just after it.

    * int8 cross-KV serving (``qeng``, the quantized engine): K5 once a
      layer in each single-token forward on the int8 cross-KV, K6 on every
      int8 decoder weight in each forward of at most 256 rows, K1 = K2 =
      32 x encoder batches, K4 = 0; then one request again under the
      profiler;
    * K4 on the file path (``eng``, unquantized bf16): once a layer in
      each single-token forward, K6 = 0."""
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    cfg = qeng.cfg
    n_layer = cfg.n_text_layer
    wave1, _ = _request_audio()
    wave = [wave1[1], wave1[3], wave1[4]]          # 12 s, 25 s, auto 8 s
    launches = {}
    with knobs(("NWT_Q8_KV_PALLAS", "NWT_Q8_KERNEL_MIN_BYTES")):
        be = BatchedEngine(qeng, max_batch=8,
                           opts=DecodeOptions(q8_cross_kv=True))
        try:
            reset_counts()
            t0 = time.perf_counter()
            ok = _run_wave(be, wave, card)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = read_counts()
            want = predicted_decode_launches(c["forwards"], n_layer)
            want.update(K1=cfg.n_audio_layer * c["batches"],
                        K2=cfg.n_audio_layer * c["batches"])
            q8_forwards = sum(n for (lay, _, _), n in c["forwards"].items()
                              if lay == "q8")
            counts_ok = (c["batches"] > 0 and q8_forwards > 0
                         and want["K4"] == 0
                         and all(c[k] == want[k] for k in want)
                         and c["K3"] == c["K9"] == c["K2-f32"] == 0
                         and no_knob_kernels(c))
            log(f"[decode] {card}: int8 cross-KV wave wall {wall:.2f} s; "
                f"batch sizes {be.batcher.batch_sizes}; decoder forwards "
                f"{c['forwards']}; launches {_launch_summary(c)} (want "
                f"{want}) -> {'PASS' if counts_ok else 'FAIL'}")
            log(f"[decode] {card}: K6 launches by rows: {c['K6-decode']} "
                f"at M <= 16 (decode kernel), {c['K6'] - c['K6-decode']} at "
                f"16 < M <= 256 (prefill kernel)")
            ok &= counts_ok
            launches.update(K5=c["K5"], K6=c["K6"])
            profile_wave(be, wave[:1], card)        # en-12s, as in serving
        finally:
            be.close()

    # K4 on the file path: the unquantized bf16 engine, packed cross-KV
    opts = DecodeOptions(temperature_increment=0.0)
    with knobs(("NWT_XATTN_KERNEL",)):
        reset_counts()
        ok &= _transcribe_one(eng, "en-12s K4", speech_like_audio(
            12.0, seed=27), card, opts)
        torch.cuda.synchronize()
        c = read_counts()
    want = predicted_decode_launches(c["forwards"], n_layer)
    k4_ok = (c["K4"] == want["K4"] > 0 and c["K5"] == c["K6"] == 0
             and c["K3"] == cfg.n_audio_layer * c["batches"]
             and no_knob_kernels(c))
    log(f"[decode] {card}: file path with NWT_XATTN_KERNEL=1: decoder "
        f"forwards {c['forwards']}; launches {_launch_summary(c)} (want K4 "
        f"{want['K4']}, K5 = K6 = 0) -> {'PASS' if k4_ok else 'FAIL'}")
    launches["K4"] = c["K4"]
    return ok and k4_ok, launches


def phase_encoder_knobs(card, qeng, eng):
    """The encoder's knob paths at full large-v3-turbo width and depth,
    the knobs set in-process around each path and restored after; counts
    set to 0 just before each path and read just after it:

    (a) int8 serving (``qeng``) with ``NWT_INT8_QKV NWT_MLP_CHUNKED
        NWT_STEM_FUSED``, one concurrent wave of two requests (one
        auto-language): K13 once per encoder batch, K10, K9, K11 and K8
        32 times per batch, K1 = K2 = K3 = 0;
    (b) one ``transcribe`` of a 12 s clip on the unquantized engine
        (``eng``) with ``NWT_STEM_FUSED``: K13 once per batch and K3 32
        times (the flat path, the stem padded to 1536 rows);
    (c) one f32 int8 encoder batch with ``NWT_INT8_QKV NWT_MLP_CHUNKED``:
        the f32 K10, K11 and K8 32 times each, no attention kernel, no K13;
    (d) one ``encode`` each under the repaired gates: ``NWT_ATTN_FUSED=0``
        (K3, not K1), ``NWT_NO_INT8_MLP`` (no K2), ``NWT_ATTN_BHTD`` (K9).
    """
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    cfg = qeng.cfg
    n = cfg.n_audio_layer
    launches = {}

    # (a) the slice: int8 serving with the three knobs
    wave1, _ = _request_audio()
    with knobs(SLICE_KNOBS):
        be = BatchedEngine(qeng, max_batch=8)
        try:
            reset_counts()
            t0 = time.perf_counter()
            ok = _run_wave(be, [wave1[1], wave1[4]], card)   # 12 s, auto 8 s
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = read_counts()
        finally:
            be.close()
    nb = c["batches"]
    a_ok = (nb > 0 and c["K13"] == nb and c["K10"] == c["K9"] == c["K11"]
            == c["K8"] == n * nb and c["K1"] == c["K2"] == c["K3"] == 0
            and c["K10-f32"] == c["K11-f32"] == c["K8-f32"] == 0
            and no_op_kernels(c))
    log(f"[knobs] {card}: int8 serving with {' '.join(SLICE_KNOBS)}: wall "
        f"{wall:.2f} s; batch sizes {be.batcher.batch_sizes}; launches "
        f"{_launch_summary(c)} (want K13 = {nb}, K10 = K9 = K11 = K8 = "
        f"{n} x {nb} = {n * nb}, K1 = K2 = K3 = 0) -> "
        f"{'PASS' if a_ok else 'FAIL'}")
    ok &= a_ok
    launches.update(K13=c["K13"], K10=c["K10"], K9=c["K9"], K11=c["K11"],
                    K8=c["K8"])

    # (b) the fused stem on the file path (flat attention, K3)
    opts = DecodeOptions(temperature_increment=0.0)
    with knobs(("NWT_STEM_FUSED",)):
        reset_counts()
        ok &= _transcribe_one(eng, "en-12s K13", speech_like_audio(
            12.0, seed=28), card, opts)
        torch.cuda.synchronize()
        c = read_counts()
    nb = c["batches"]
    b_ok = (nb > 0 and c["K13"] == nb and c["K3"] == n * nb
            and c["K1"] == c["K9"] == c["K10"] == c["K8"] == 0
            and no_op_kernels(c))
    log(f"[knobs] {card}: file path with NWT_STEM_FUSED=1: launches "
        f"{_launch_summary(c)} (want K13 = {nb}, K3 = {n} x {nb}) -> "
        f"{'PASS' if b_ok else 'FAIL'}")
    ok &= b_ok

    # (c) the int8 encoder at f32 compute with K10, K11 and K8
    enc32 = {"encoder": {k: (v.float() if torch.is_tensor(v) else
                             {kk: vv.float() for kk, vv in v.items()})
                         for k, v in eng.params["encoder"].items()}}
    enc32 = quantize_encoder_params(enc32)
    mel = torch.from_numpy(np.random.RandomState(29).randn(
        1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)).cuda()
    with knobs(SLICE_KNOBS):
        reset_counts()
        xa = mw.encode(enc32, mel, cfg, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        c = read_counts()
    c_ok = (c["K10-f32"] == c["K11-f32"] == c["K8-f32"] == c["K10"]
            == c["K11"] == c["K8"] == n and c["K13"] == 0
            and c["K1"] == c["K3"] == c["K9"] == c["K2"] == 0
            and no_op_kernels(c) and xa.dtype == torch.float32
            and tuple(xa.shape) == (1, cfg.n_audio_ctx, cfg.n_audio_state)
            and bool(torch.isfinite(xa).all()))
    log(f"[knobs] {card}: int8 encoder at f32 with {' '.join(SLICE_KNOBS)}, "
        f"one batch: launches {_launch_summary(c)} (want K10 = K11 = K8 = "
        f"{n}, all f32; no attention kernel, no K13), states "
        f"{tuple(xa.shape)} finite -> {'PASS' if c_ok else 'FAIL'}")
    ok &= c_ok
    launches.update({"K10-f32": c["K10-f32"], "K11-f32": c["K11-f32"],
                     "K8-f32": c["K8-f32"]})
    del enc32, xa
    torch.cuda.empty_cache()

    # (d) the repaired gates, one encoder batch each on the int8 engine
    for env, want in ((dict(NWT_ATTN_FUSED="0"), dict(K3=n, K1=0, K2=n)),
                      (dict(NWT_NO_INT8_MLP="1"), dict(K1=n, K2=0)),
                      (dict(NWT_ATTN_BHTD="1"), dict(K9=n, K1=0, K2=n))):
        with knobs(**env):
            reset_counts()
            xa = mw.encode(qeng.params, mel, cfg,
                           compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            c = read_counts()
        d_ok = (all(c[k] == v for k, v in want.items())
                and no_knob_kernels(c) and bool(torch.isfinite(
                    xa.float()).all()))
        (name, value), = env.items()
        log(f"[knobs] {card}: int8 encoder at bf16 with {name}={value}: "
            f"launches {_launch_summary(c)} (want {want}) -> "
            f"{'PASS' if d_ok else 'FAIL'}")
        ok &= d_ok
    return ok, launches


ENCODER_KERNELS = ("K1", "K2", "K2-f32", "K3", "K8", "K9", "K10", "K11",
                   "K13", "K4", "K5", "K6")


def only(c, want):
    """Every encoder kernel (and K4-K7, K14) launched as ``want`` says,
    the others not at all."""
    return all(c[k] == want.get(k, 0)
               for k in ENCODER_KERNELS + ("K12",) + tuple(variant_names())
               + OP_KERNELS)


def phase_attention_variants(card, qeng, eng):
    """The last encoder variants' paths at full large-v3-turbo width and
    depth, the knobs set in-process around each path and restored after;
    counts set to 0 just before each path and read just after it:

    (a) int8 serving (``qeng``) with ``NWT_ATTN_FUSED=3``, one concurrent
        wave of the 12 s and the auto-language 8 s requests: K12 32 times
        per encoder batch, no K1, K2, K3 or K8;
    (b) one int8 encoder batch with ``NWT_ATTN_FUSED=2``: K1 with the o
        projection fused and K2, 32 each, no default K1;
    (c) one int8 encoder batch each with ``NWT_ATTN_I8``, ``NWT_ATTN_I8PV``
        and both: that K1 variant and K2, 32 each;
    (d) one ``transcribe`` of a 12 s clip on the unquantized engine
        (``eng``) with both int8 knobs: K3 with both variants 32 times per
        batch; and one float encoder batch each with ``NWT_ATTN_I8`` and
        with ``NWT_ATTN_I8PV``: that K3 variant 32 times;
    (e) one int8 encoder batch with ``NWT_ATTN_FUSED=3 NWT_ATTN_I8=1
        NWT_ATTN_I8PV=1``: K12 with both int8 variants 32 times."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    cfg = qeng.cfg
    n = cfg.n_audio_layer
    launches = {}

    # (a) int8 serving through K12
    wave1, _ = _request_audio()
    with knobs(NWT_ATTN_FUSED="3"):
        be = BatchedEngine(qeng, max_batch=8)
        try:
            reset_counts()
            t0 = time.perf_counter()
            ok = _run_wave(be, [wave1[1], wave1[4]], card)   # 12 s, auto 8 s
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = read_counts()
        finally:
            be.close()
    nb = c["batches"]
    a_ok = nb > 0 and only(c, {"K12": n * nb})
    log(f"[variants] {card}: int8 serving with NWT_ATTN_FUSED=3: wall "
        f"{wall:.2f} s; batch sizes {be.batcher.batch_sizes}; launches "
        f"{_launch_summary(c)} (want K12 = {n} x {nb} = {n * nb}, no other "
        f"encoder kernel) -> {'PASS' if a_ok else 'FAIL'}")
    ok &= a_ok
    launches["K12"] = c["K12"]

    # (b), (c), (e): one int8 encoder batch under each knob set
    mel = torch.from_numpy(np.random.RandomState(31).randn(
        1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)).cuda()
    i8 = dict(NWT_ATTN_I8="1", NWT_ATTN_I8PV="1")
    cases = [(dict(NWT_ATTN_FUSED="2"), {"K1-o": n, "K2": n}),
             (dict(NWT_ATTN_I8="1"), {"K1-i8s": n, "K2": n}),
             (dict(NWT_ATTN_I8PV="1"), {"K1-i8pv": n, "K2": n}),
             (i8, {"K1-i8s-i8pv": n, "K2": n}),
             (dict(NWT_ATTN_FUSED="3", **i8), {"K12-i8s-i8pv": n})]
    for env, want in cases:
        with knobs(**env):
            reset_counts()
            xa = mw.encode(qeng.params, mel, cfg,
                           compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            c = read_counts()
        this = only(c, want) and tuple(xa.shape) == (
            1, cfg.n_audio_ctx, cfg.n_audio_state) and bool(
            torch.isfinite(xa.float()).all())
        log(f"[variants] {card}: int8 encoder batch with "
            f"{' '.join(f'{k}={v}' for k, v in env.items())}: launches "
            f"{_launch_summary(c)} (want {want}) -> "
            f"{'PASS' if this else 'FAIL'}")
        ok &= this
        for k in want:
            if k != "K2":
                launches[k] = launches.get(k, 0) + c[k]

    # (d) the unquantized file path through K3's int8 variants
    opts = DecodeOptions(temperature_increment=0.0)
    with knobs(**i8):
        reset_counts()
        ok &= _transcribe_one(eng, "en-12s K3 int8", speech_like_audio(
            12.0, seed=32), card, opts)
        torch.cuda.synchronize()
        c = read_counts()
    nb = c["batches"]
    d_ok = nb > 0 and only(c, {"K3-i8s-i8pv": n * nb})
    log(f"[variants] {card}: file path with NWT_ATTN_I8=1 NWT_ATTN_I8PV=1: "
        f"launches {_launch_summary(c)} (want K3-i8s-i8pv = {n} x {nb}) -> "
        f"{'PASS' if d_ok else 'FAIL'}")
    ok &= d_ok
    launches["K3-i8s-i8pv"] = c["K3-i8s-i8pv"]
    for env, key in ((dict(NWT_ATTN_I8="1"), "K3-i8s"),
                     (dict(NWT_ATTN_I8PV="1"), "K3-i8pv")):
        with knobs(**env):
            reset_counts()
            xa = mw.encode(eng.params, mel, cfg,
                           compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            c = read_counts()
        this = only(c, {key: n}) and bool(torch.isfinite(xa.float()).all())
        log(f"[variants] {card}: float encoder batch with "
            f"{' '.join(f'{k}={v}' for k, v in env.items())}: launches "
            f"{_launch_summary(c)} (want {key} = {n}) -> "
            f"{'PASS' if this else 'FAIL'}")
        ok &= this
        launches[key] = c[key]
    return ok, launches


def reference_variants(dev, cfg, mel, to_dev):
    """The d=128 dh=64 int8 encoder at bf16 with ``NWT_ATTN_FUSED=3
    NWT_ATTN_I8=1 NWT_ATTN_I8PV=1`` (K12 with both int8 variants once a
    layer) and with ``NWT_ATTN_FUSED=2`` (K1 with the o projection and K2
    once a layer), on the card against the same model's plain run on the
    CPU."""
    import torch
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    n = cfg.n_audio_layer
    qp = quantize_encoder_params(mw.init_params(3, cfg, dtype=torch.bfloat16))
    ok = True
    for env, want in ((dict(NWT_ATTN_FUSED="3", NWT_ATTN_I8="1",
                            NWT_ATTN_I8PV="1"), {"K12-i8s-i8pv": n}),
                      (dict(NWT_ATTN_FUSED="2"), {"K1-o": n, "K2": n})):
        with knobs(**env):
            reset_counts()
            got = mw.encode(to_dev(qp), mel.to(dev), cfg,
                            compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            c = read_counts()
            ref = mw.encode(qp, mel, cfg, compute_dtype=torch.bfloat16)
        err = (got.float().cpu() - ref.float()).abs().max().item()
        this = only(c, want) and bool(torch.isfinite(got.float()).all()) \
            and err < ENC_TOL
        log(f"[reference] int8 encoder d=128 dh=64 bf16 with "
            f"{' '.join(f'{k}={v}' for k, v in env.items())}, card vs CPU "
            f"plain: max_abs_err {err:.3e} (tol {ENC_TOL}); launches "
            f"{_launch_summary(c)} (want {want}) -> "
            f"{'PASS' if this else 'FAIL'}")
        ok &= this
    return ok


def phase_ops(card, qeng):
    """The raw-PCM path and the two ops that no serving path takes, each
    driven through the entry point a caller uses, with the counts set to 0
    just before and read just after:

    (a) ``log_mel_spectrogram`` on one 30 s window on the card, against
        ``log_mel_numpy_f64`` on the host with the reference's bounds
        (tests/test_mel.py:48-57: mean < 2e-4, max < 0.03); it runs plain
        torch ops, so no kernel launches (K14 = 0);
    (b) ``log_mel_spectrogram_pallas`` on the serving wave 1's five
        requests, each padded to a 30 s window: K14 once, no other kernel,
        within 1e-4 of ``log_mel_spectrogram``;
    (c) one decode step's MLPs through ``fused_mlp_q8``: eight rows of
        hidden states through each decoder layer's int8 MLP of the turbo
        engine (``qeng``): K7 once a layer, each within its tolerance of
        the plain version."""
    import numpy as np
    import torch
    from nobs_whisper_torch.audio.mel import (log_mel_numpy_f64,
                                              log_mel_spectrogram, pad_or_trim)
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops import fused_mlp as fm
    from nobs_whisper_torch.ops import mel_pallas as mp
    cfg = qeng.cfg
    launches = {}
    wave1, _ = _request_audio()

    # (a) the raw-PCM path against the f64 oracle
    host = np.asarray(pad_or_trim(torch.from_numpy(wave1[2][1])))
    reset_counts()
    mel = log_mel_spectrogram(torch.from_numpy(host).cuda(), cfg.n_mels)
    torch.cuda.synchronize()
    c = read_counts()
    err = np.abs(mel.cpu().numpy() - log_mel_numpy_f64(host, cfg.n_mels))
    a_ok = (mel.device.type == "cuda" and tuple(mel.shape) == (
        cfg.n_mels, 3000) and err.mean() < 2e-4 and err.max() < 0.03
        and only(c, {}))
    log(f"[ops] {card}: log_mel_spectrogram of one 30 s window "
        f"({wave1[2][0]}) on the card against log_mel_numpy_f64: mean "
        f"{err.mean():.3e} (< 2e-4), max {err.max():.3e} (< 0.03); "
        f"launches {_launch_summary(c)} (want none) -> "
        f"{'PASS' if a_ok else 'FAIL'}")

    # (b) K14 on the serving requests' windows
    audio = torch.from_numpy(np.stack([
        np.asarray(pad_or_trim(torch.from_numpy(a))) for _, a, _ in wave1
    ])).cuda()
    reset_counts()
    got = mp.log_mel_spectrogram_pallas(audio, cfg.n_mels)
    torch.cuda.synchronize()
    c = read_counts()
    err = (got - log_mel_spectrogram(audio, cfg.n_mels)).abs().max().item()
    b_ok = (only(c, {"K14": 1}) and err <= K14_TOL
            and tuple(got.shape) == (len(wave1), cfg.n_mels, 3000))
    log(f"[ops] {card}: log_mel_spectrogram_pallas of wave 1's "
        f"{len(wave1)} requests as 30 s windows: launches "
        f"{_launch_summary(c)} (want K14 = 1), max |K14 - "
        f"log_mel_spectrogram| {err:.3e} (<= {K14_TOL}) -> "
        f"{'PASS' if b_ok else 'FAIL'}")
    launches["K14"] = c["K14"]

    # (c) K7 on each decoder layer's int8 MLP, one decode step of 8 rows
    g = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randn(8, cfg.n_text_state, generator=g, device="cuda").to(
        torch.bfloat16)
    reset_counts()
    outs = []
    for layer in range(cfg.n_text_layer):
        p = mw._layer(qeng.params["decoder"]["blocks"], layer)
        outs.append((p, fm.fused_mlp_q8(x, p["ln2_g"], p["ln2_b"],
                                        p["fc1_w"], p["fc1_b"], p["fc2_w"],
                                        p["fc2_b"])))
    torch.cuda.synchronize()
    c = read_counts()
    steps = 0.0
    for p, got in outs:
        ref = fm.fused_mlp_q8_plain(x, p["ln2_g"], p["ln2_b"], p["fc1_w"],
                                    p["fc1_b"], p["fc2_w"], p["fc2_b"])
        steps = max(steps, ((got.float() - ref.float()).abs() / (
            K1_STEP["atol"] + K1_STEP["rtol"] * ref.float().abs())
        ).max().item())
    c_ok = only(c, {"K7": cfg.n_text_layer}) and steps <= 1.0
    log(f"[ops] {card}: fused_mlp_q8 on the {cfg.n_text_layer} int8 "
        f"decoder MLPs of the turbo engine, 8 rows bf16: launches "
        f"{_launch_summary(c)} (want K7 = {cfg.n_text_layer}), max |kernel "
        f"- plain| / (atol + rtol |plain|) {steps:.3f} (<= 1, {K1_STEP}) -> "
        f"{'PASS' if c_ok else 'FAIL'}")
    launches["K7"] = c["K7"]
    return a_ok and b_ok and c_ok, launches


def write_cli_checkpoint(path):
    """The dh=64 tiny GGML checkpoint of the CLI subprocesses (d=128, two
    heads, seed 3)."""
    from nobs_whisper_torch.utils.testing import (tiny_test_config,
                                                  write_tiny_checkpoint)
    write_tiny_checkpoint(path, cfg=tiny_test_config(d=128, heads=2), seed=3)


def phase_cli(card):
    """``python -m nobs_whisper_torch.cli transcribe`` in a subprocess on
    the card (default device and dtype: cuda, bf16), on a dh=64 tiny GGML
    checkpoint and a WAV written by the port's own helpers."""
    import tempfile
    from nobs_whisper_torch.audio.io import write_wav
    from nobs_whisper_torch.utils.testing import speech_like_audio
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "ggml-tiny-dh64.bin")
        wav = os.path.join(tmp, "clip.wav")
        write_cli_checkpoint(model)
        write_wav(wav, speech_like_audio(2.0, seed=26))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nobs_whisper_torch.cli", "transcribe",
             wav, "--model", model, "--language", "en"],
            capture_output=True, text=True, cwd=root, timeout=300)
    lines = r.stdout.strip().splitlines()
    ok = r.returncode == 0 and bool(lines)
    log(f"[cli] {card}: transcribe verb exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s, last line {lines[-1][:60]!r}"
        if lines else f"[cli] {card}: exit {r.returncode}, no output; "
        f"stderr {r.stderr[-2000:]}")
    log(f"[cli] -> {'PASS' if ok else 'FAIL'}")
    return ok


SERVER_VOCAB = "Kubernetes, pallas, GitHub, PyTorch, Hopper"


def _session_run(base, name, audio, rate, out, session=None):
    """One push-to-talk session through the port's client (``session``, or
    a new one): SSE read in a thread of its own (first-partial time), 0.5 s
    raw f32 bodies, stop (final latency from the stop request), then the
    stream to ``done``."""
    from nobs_whisper_torch.client import Client
    s = session or Client(base, timeout=600).session(language="en",
                                                      sample_rate=rate)
    evs = s.events(timeout=600)
    got = []

    def read():
        for ev in evs:
            got.append((time.perf_counter(), ev))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    t0 = time.perf_counter()
    s.start()
    step = rate // 2
    for i in range(0, len(audio), step):
        s.push_audio(audio[i:i + step])
    t_stop = time.perf_counter()
    final = s.stop()
    t_done = time.perf_counter()
    reader.join(timeout=120)
    s.delete()
    out[name] = dict(t0=t0, t_stop=t_stop, t_done=t_done, final=final,
                     events=got, audio_s=len(audio) / rate)


def _ws_run(base, name, audio, rate, out):
    """One dictation session over the session's WebSocket: JSON verbs up,
    binary f32 bodies up, replies and events down, until the stop reply
    and the ``done`` event."""
    import json as _json
    from nobs_whisper_torch.client import Client
    c = Client(base, timeout=600)
    s = c.session(language="en", sample_rate=rate)
    sock = s.websocket(timeout=600)
    got, replies = [], {}
    t0 = time.perf_counter()
    try:
        sock.send_json({"verb": "start"})
        step = rate // 2
        for i in range(0, len(audio), step):
            sock.send_binary(audio[i:i + step].astype("<f4").tobytes())
        t_stop = time.perf_counter()
        sock.send_json({"verb": "stop"})
        while "stop" not in replies or not any(
                ev["state"] == "done" for _, ev in got):
            msg = sock.recv()
            if msg is None:
                break
            obj = _json.loads(msg[1])
            if "event" in obj:
                got.append((time.perf_counter(), obj["event"]))
            elif "reply" in obj:
                replies[obj["reply"]] = obj
    finally:
        sock.close()
    s.delete()
    out[name] = dict(t0=t0, t_stop=t_stop, t_done=time.perf_counter(),
                     final=replies.get("stop", {}).get("transcript"),
                     replies=replies, audio_s=len(audio) / rate,
                     events=[(t, _ev(e)) for t, e in got])


def _ev(d):
    from nobs_whisper_torch.client import SessionEvent
    return SessionEvent(state=d["state"], transcript=d.get("transcript"),
                        is_final=bool(d.get("is_final")))


def _free_port():
    import socket
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def phase_server(card, qeng):
    """The session server on the card (``serve/server.py`` over
    ``BatchedEngine(qeng, max_batch=8)``, the int8 large-v3-turbo engine
    from seed 0), driven through the port's ``client.py``:

    * ``warmup()`` (one batch of each size), then ``POST /config``:
      language en and a custom vocabulary, which every call then carries
      as its prompt through the port's own BPE encoder;
    * three concurrent push-to-talk sessions of 35-45 s of speech-like
      audio at 48 kHz in 0.5 s raw f32 bodies and one WebSocket dictation
      session beside them: each gets 2 or more partials (so at least one
      chunk's prompt carries the previous chunk's text), a non-empty final
      transcript and the states recording -> processing -> done;
    * one ``POST /transcribe`` of a 12 s 16 kHz WAV, alone, whose tokens
      equal those of ``BatchedEngine.transcribe`` called directly on the
      same engine and audio with nothing in flight;
    * ``/health`` (loaded) and ``/stats`` (chunks, tokens, batch sizes,
      no watchdog trip).

    The batcher runs with the fallback ladder off (``temperature_increment
    =0``, the serve verb's ``--temperature-increment 0``): random weights
    fail every rung's gates, so each chunk would otherwise decode all six
    rungs. The one-shot's options are the server's defaults, which differ
    from the batcher's, so it and the direct call take ``BatchedEngine``'s
    sequential path, ladder and all. Counts are set to 0 just before the
    warmup and read after the direct call: K1 = K2 = 32 x encoder batches,
    every other kernel 0. ``tiktoken`` must not be loaded at the end. Then
    ``python -m nobs_whisper_torch.cli serve`` in a subprocess on the CLI
    phase's tiny checkpoint answers ``/health`` and ``/transcribe`` and
    exits 0 on SIGINT."""
    import importlib.util
    import io
    import tempfile
    import torch
    from nobs_whisper_torch.audio.io import read_wav, write_wav
    from nobs_whisper_torch.client import Client
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = qeng.cfg
    # the server's config and models live in a home of this run's own
    tmp = tempfile.TemporaryDirectory(prefix="nwt-home-")
    home = tmp.name
    old_home = os.environ.get("NOBS_WHISPER_TPU_HOME")
    os.environ["NOBS_WHISPER_TPU_HOME"] = home
    ok = True
    be = BatchedEngine(qeng, opts=DecodeOptions(temperature_increment=0.0),
                       max_batch=8)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    httpd = serve(be, host="127.0.0.1", port=port, background=True)
    client = Client(base, timeout=600)
    t_phase = time.perf_counter()
    try:
        reset_counts()
        t0 = time.perf_counter()
        sizes = be.warmup()
        torch.cuda.synchronize()
        log(f"[server] {card}: warmup sizes {sizes} (and one "
            f"language-detection batch of 8) in "
            f"{time.perf_counter() - t0:.1f} s")
        conf = client.set_config(language="en",
                                 custom_vocabulary=SERVER_VOCAB)
        health = client.health()
        ok &= bool(health["loaded"]) and conf["language"] == "en"
        n_warm = len(be.batcher.batch_sizes)

        # three push-to-talk sessions and a WebSocket session at once
        rate, runs, out = 48000, [], {}
        for i, dur in enumerate((35.0, 40.0, 45.0)):
            runs.append(threading.Thread(target=_session_run, args=(
                base, f"ptt-{i}", speech_like_audio(dur, seed=1 + i,
                                                   sample_rate=rate),
                rate, out)))
        runs.append(threading.Thread(target=_ws_run, args=(
            base, "ws", speech_like_audio(20.0, seed=9, sample_rate=rate),
            rate, out)))
        t0 = time.perf_counter()
        for th in runs:
            th.start()
        for th in runs:
            th.join(timeout=600)
        sessions_wall = time.perf_counter() - t0
        for name in ("ptt-0", "ptt-1", "ptt-2", "ws"):
            r = out.get(name)
            if r is None:
                log(f"[server] {card}: {name}: FAILED (no result)")
                ok = False
                continue
            states = [ev.state for _, ev in r["events"]]
            partials = [(t, ev) for t, ev in r["events"]
                        if ev.state == "partial"]
            steps = [st for st in states if st != "partial"]
            s_ok = (len(partials) >= 2 and bool(r["final"])
                    and steps == ["recording", "processing", "done"]
                    and r["events"][-1][1].is_final)
            if name == "ws":
                s_ok &= r["replies"].get("start", {}).get("started") is True
            first = (partials[0][0] - r["t0"]) if partials else float("nan")
            log(f"[server] {card}: {name} ({r['audio_s']:.1f} s at {rate} "
                f"Hz): partials {len(partials)}, first partial "
                f"{first:.2f} s after start, final {r['t_done'] - r['t_stop']:.2f}"
                f" s after the last body, states {steps}, final transcript "
                f"{len(r['final'] or '')} chars -> "
                f"{'PASS' if s_ok else 'FAIL'}")
            ok &= s_ok

        # one-shot, alone, against the direct call
        clip = speech_like_audio(12.0, seed=21)
        buf = io.BytesIO()
        write_wav(buf, clip, 16000)
        wav = buf.getvalue()
        t0 = time.perf_counter()
        one = client.transcribe(wav)
        one_s = time.perf_counter() - t0
        audio, _ = read_wav(wav)
        direct = be.transcribe(audio, language="en", vocabulary=SERVER_VOCAB,
                               opts=DecodeOptions())
        torch.cuda.synchronize()
        got = [s_["tokens"] for s_ in one["segments"]]
        want = [s_.tokens for s_ in direct.segments]
        o_ok = got == want and bool(want) and one["text"] == direct.text
        log(f"[server] {card}: one-shot POST /transcribe (12.0 s WAV) "
            f"latency {one_s:.2f} s, segments {len(got)}, tokens "
            f"{sum(map(len, got))}; equal to BatchedEngine.transcribe "
            f"called directly: {got == want} -> {'PASS' if o_ok else 'FAIL'}")
        ok &= o_ok

        c = read_counts()
        batches = c["batches"]
        want_n = cfg.n_audio_layer * batches
        counts_ok = (batches > 0 and c["K1"] == c["K2"] == want_n
                     and only(c, {"K1": want_n, "K2": want_n})
                     and not any(c[k] for k in ("K4", "K5", "K6")))
        log(f"[server] {card}: launches {_launch_summary(c)} (want K1 = K2 "
            f"= {cfg.n_audio_layer} x {batches} = {want_n}, others 0) -> "
            f"{'PASS' if counts_ok else 'FAIL'}")
        ok &= counts_ok
        launches = {"K1": c["K1"], "K2": c["K2"]}

        health, stats = client.health(), client.stats()
        b = stats.get("batcher", {})
        d = stats.get("decode", {})
        st_ok = (health["loaded"] is True and d.get("chunks", 0) > 0
                 and d.get("tokens_emitted", 0) > 0
                 and b.get("watchdog_trips") == 0
                 and b.get("max_batch", 0) >= 2)
        log(f"[server] {card}: /health {health}; /stats decode {d}, "
            f"batcher {b} -> {'PASS' if st_ok else 'FAIL'}")
        ok &= st_ok
        served = be.batcher.batch_sizes[n_warm:]
        log(f"[server] {card}: wall {time.perf_counter() - t_phase:.2f} s "
            f"(sessions {sessions_wall:.2f} s, one-shot {one_s:.2f} s); "
            f"batch sizes after warmup {served}")
    finally:
        httpd.shutdown()
        be.close()
    tk_loaded = "tiktoken" in sys.modules
    tk_installed = importlib.util.find_spec("tiktoken") is not None
    log(f"[server] tiktoken installed: {tk_installed}; "
        f"loaded by this run: {tk_loaded} -> "
        f"{'PASS' if not tk_loaded else 'FAIL'}")
    ok &= not tk_loaded
    try:
        ok &= serve_verb(card, home)
    finally:
        if old_home is None:
            os.environ.pop("NOBS_WHISPER_TPU_HOME", None)
        else:
            os.environ["NOBS_WHISPER_TPU_HOME"] = old_home
        tmp.cleanup()
    return ok, launches


def serve_verb(card, home, extra=(), tag="server"):
    """``python -m nobs_whisper_torch.cli serve`` in a subprocess on the
    card (defaults: cuda, bf16, int8) on the CLI phase's tiny checkpoint
    with ``--batch 4 --warmup`` and ``extra``: ``/health`` within a
    deadline, one ``POST /transcribe``, then SIGINT, and exit 0 within a
    deadline."""
    import json as _json
    import signal
    import urllib.request
    from nobs_whisper_torch.utils.testing import speech_like_audio
    root = os.path.dirname(os.path.abspath(__file__))
    model = os.path.join(home, "ggml-tiny-dh64.bin")
    write_cli_checkpoint(model)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, NOBS_WHISPER_TPU_HOME=home)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nobs_whisper_torch.cli", "serve", "--model",
         model, "--batch", "4", "--warmup", "--port", str(port), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=env)
    health, err, rc, one, one_s, t_up = None, "", None, {}, 0.0, 0.0
    try:
        deadline = time.monotonic() + 240
        while health is None and time.monotonic() < deadline \
                and proc.poll() is None:
            try:
                with urllib.request.urlopen(base + "/health",
                                            timeout=5) as r:
                    health = _json.loads(r.read())
            except OSError:
                time.sleep(0.5)
        t_up = time.perf_counter() - t0
        if health is not None:
            pcm = speech_like_audio(2.0, seed=27).astype("<f4").tobytes()
            req = urllib.request.Request(base + "/transcribe?language=en",
                                         data=pcm, method="POST")
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                one = _json.loads(r.read())
            one_s = time.perf_counter() - t1
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
    except Exception as e:      # reported below, fails the phase
        err = f"{e!r}\n"
    finally:
        if proc.poll() is None:
            proc.kill()
        err += proc.communicate(timeout=60)[1]
    v_ok = (health is not None and health.get("loaded") is True
            and rc == 0 and isinstance(one.get("text"), str))
    warm = [ln for ln in err.splitlines() if "warmup done" in ln]
    log(f"[{tag}] {card}: serve verb subprocess {' '.join(extra)}: "
        f"/health {health} {t_up:.1f} s after launch "
        f"({warm[-1] if warm else 'no warmup'}), one-shot {one_s:.2f} s, "
        f"exit {rc} on SIGINT -> {'PASS' if v_ok else 'FAIL'}")
    if not v_ok:
        log(f"[{tag}] serve verb stderr: {err[-3000:]}")
    return v_ok


BEAM_K = 5


def _beam_wave():
    """Five fixed-language window requests (5-25 s) and one auto-language
    request, sent at once."""
    wave1, wave2 = _request_audio()
    return wave1 + wave2[:1]


def _beam_check(res, sample_len):
    """A beam window result is well formed: at most ``sample_len`` tokens,
    a finite sum, no-speech probability in [0, 1], temperature 0."""
    import math
    return (len(res.tokens) <= sample_len and math.isfinite(res.sum_logprob)
            and 0.0 <= res.no_speech_prob <= 1.0 and res.temperature == 0.0)


def _windows_xa(eng, n, seed):
    """Encoder states of ``n`` speech-like 30 s windows (one batch)."""
    import numpy as np
    import torch
    from nobs_whisper_torch.audio.mel import frame_window_np
    from nobs_whisper_torch.decode.greedy import frames_encode_impl
    from nobs_whisper_torch.utils.testing import speech_like_audio
    cfg = eng.cfg
    frames = np.stack([frame_window_np(speech_like_audio(
        20.0, seed=seed + i), n_frames=2 * cfg.n_audio_ctx)
        for i in range(n)])
    return frames_encode_impl(eng.params, torch.from_numpy(frames).cuda(),
                              cfg, eng.compute_dtype)


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def beam_parts_ms(cfg, b, p_max=8, sample_len=224):
    """Device ms of one step's beam-only parts at B elements x BEAM_K rows
    at turbo's shapes, each alone in a CUDA graph: the cache reorder
    (``index_select`` of the bf16 self-KV cache of every layer into the
    second buffer), the grouped cross-attention of every layer (f32 copies
    of the packed cross-KV, as the beam loop holds them) and
    ``beam_step`` (the stable sorts of the top-k)."""
    import torch
    from nobs_whisper_torch.decode.beam import beam_step
    from nobs_whisper_torch.models.whisper import init_kv_cache
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.utils.profiling import graph_ms
    dev, k = torch.device("cuda"), BEAM_K
    bk, h, dh = b * k, cfg.n_text_head, cfg.head_dim
    t = min(-(-(p_max + sample_len) // 8) * 8, cfg.n_text_ctx)
    cache = init_kv_cache(cfg, bk, dtype=torch.bfloat16, t_ctx=t, device=dev)
    spare = tuple(torch.empty_like(c) for c in cache)
    src = torch.randint(0, bk, (bk,), device=dev)
    tp = -(-cfg.n_audio_ctx // 128) * 128
    kT = torch.randn(b, h, dh, tp, device=dev)
    v = torch.randn(b, h, tp, dh, device=dev)
    q = torch.randn(b, k, h, 1, dh, device=dev, dtype=torch.bfloat16)
    lp = torch.log_softmax(torch.randn(b, k, cfg.n_vocab, device=dev), -1)
    cum = torch.randn(b, k, device=dev)
    fin = torch.zeros(b, k, dtype=torch.bool, device=dev)

    def reorder():
        for c, s_ in zip(cache, spare):
            torch.index_select(c, 1, src, out=s_)

    def xattn():
        for _ in range(cfg.n_text_layer):
            ap.cross_attention_kt_xla_grouped(q, {"kT": kT, "v": v},
                                              cfg.n_audio_ctx)

    out = []
    for name, fn in (("reorder", reorder), ("grouped cross-attention", xattn),
                     ("beam_step (top-k)",
                      lambda: beam_step(cum, lp, fin, cfg.eot, False))):
        try:
            out.append(f"{name} {graph_ms(fn):.4f} ms")
        except Exception as e:      # reported, not fatal: a measurement
            out.append(f"{name} not measured ({e!r})")
    return ", ".join(out)


def phase_beam(card, qeng, eng):
    """Beam search on the card at large-v3-turbo's width, random weights
    from seed 0; counts set to 0 just before each path and read just after
    it.

    * the beam serving path: ``BatchedEngine(qeng, opts=DecodeOptions(
      beam_size=5, temperature_increment=0), max_batch=8)``, one wave of
      five fixed-language window requests and one auto-language request,
      then a 45 s long-form request: K1 = K2 = 32 x encoder batches, K4 =
      K5 = K6 = 0, one language-detect forward (the auto-language row's
      batch; the detect forward is the only one on the plain cross-KV),
      every window result well formed; then one request again under
      ``torch.profiler`` (device busy, idle share, the largest rows), ms
      per step of beam and greedy on the same encoder states at B=1 and
      B=8, and the reorder, the grouped cross-attention and the top-k of
      one step each alone at B=8 (``beam_parts_ms``);
    * the unquantized bf16 ``eng.transcribe`` of a 12 s clip at beam 5:
      K3 = 32 x encoder batches, no other attention kernel;
    * under ``NWT_XATTN_KERNEL=1``, one beam batch: every forward grouped,
      K4 = 0; under ``NWT_Q8_KERNEL_MIN_BYTES=1``, one beam batch at B=1
      and one at B=8: K6's decode-kernel and prefill-kernel launches as
      the gates predict from the forwards run;
    * ``NWT_BEAM_ANCESTRY=1`` on one B=8 batch: the share of rows whose
      tokens equal the permuted run's (printed)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nobs_whisper_torch.decode.beam import beam_decode_window
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = qeng.cfg
    n_enc, n_dec = cfg.n_audio_layer, cfg.n_text_layer
    sample_len = cfg.n_text_ctx // 2
    opts = DecodeOptions(beam_size=BEAM_K, temperature_increment=0.0)
    t_phase = time.perf_counter()
    launches = {}

    # --- the beam serving path --------------------------------------------
    be = BatchedEngine(qeng, opts=opts, max_batch=8)
    windows, batch_walls = [], []
    run_batch, beam_results = be.batcher._run_batch, be.batcher._beam_results

    def timed_batch(batch):
        out, dt = _timed(lambda: run_batch(batch))
        batch_walls.append((len(batch), dt))
        return out

    def seen_results(*a):
        out = beam_results(*a)
        windows.extend(out)
        return out

    be.batcher._run_batch = timed_batch
    be.batcher._beam_results = seen_results
    try:
        reset_counts()
        t0 = time.perf_counter()
        ok = _run_wave(be, _beam_wave(), card)
        ok &= _run_wave(be, [("longform-45s", speech_like_audio(
            45.0, seed=8), "en")], card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
    finally:
        be.close()
    batches = c["batches"]
    want = n_enc * batches
    detect = sum(n for (lay, _, _), n in c["forwards"].items()
                 if lay == "plain")
    grouped = {k: n for k, n in c["forwards"].items() if k[0] == "grouped"}
    forms_ok = bool(windows) and all(_beam_check(r, sample_len)
                                     for r in windows)
    counts_ok = (batches > 0 and c["K1"] == c["K2"] == want
                 and c["K3"] == c["K9"] == c["K2-f32"] == 0
                 and c["K4"] == c["K5"] == c["K6"] == 0
                 and no_knob_kernels(c) and detect == 1 and bool(grouped))
    log(f"[beam] {card}: serving wall {wall:.2f} s; batch sizes "
        f"{be.batcher.batch_sizes}; encoder batches {batches}; window "
        f"results {len(windows)} well formed {forms_ok} (tokens <= "
        f"{sample_len}, finite sums, no-speech in [0, 1]); language-detect "
        f"forwards {detect} (want 1); launches {_launch_summary(c)} (want "
        f"K1 = K2 = {n_enc} x {batches} = {want}, K4 = K5 = K6 = 0) -> "
        f"{'PASS' if counts_ok and forms_ok else 'FAIL'}")
    ok &= counts_ok and forms_ok
    launches.update(K1=c["K1"], K2=c["K2"])
    rows = sorted({b for (_, b, s) in grouped if s == 1})
    steps = sum(n for (_, _, s), n in grouped.items() if s == 1)

    # --- one request under the profiler, one beam rung ----------------------
    one = BatchedEngine(qeng, opts=opts, max_batch=8)
    prof_line = "not measured"
    idle = float("nan")
    try:
        req = _request_audio()[0][1]               # en-12s, as in [serve]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _run_wave(one, [req], card)
            torch.cuda.synchronize()
            p_wall = time.perf_counter() - t0
        ka = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        busy = sum(getattr(e, attr) for e in ka) / 1e6
        idle = max(0.0, 1 - busy / p_wall)
        top = sorted(ka, key=lambda e: -getattr(e, attr))[:6]
        prof_line = (f"wall {p_wall:.3f} s, device busy {busy:.3f} s, idle "
                     f"share {idle:.3f}; largest device rows: " + "; ".join(
                         f"{getattr(e, attr) / 1e3:.2f} ms {e.count}x "
                         f"{e.key[:60]}" for e in top))
    except Exception as e:          # reported, not fatal: a measurement
        prof_line = f"not measured: {e!r}"
    finally:
        one.close()
    log(f"[beam] {card}: profiled request (en-12s, one beam rung): "
        f"{prof_line}")

    # --- ms per step, beam and greedy on the same encoder states -----------
    tables = build_rule_tables(cfg, opts, qeng.tokenizer, device="cuda")
    prompt = qeng.tokenizer.sot_sequence(language="en")
    xa8 = _windows_xa(qeng, 8, seed=40)
    per_step, n_step = {}, 64
    for b in (1, 8):
        xa = xa8[:b]
        _, t_beam = _timed(lambda: beam_decode_window(
            qeng.params, xa, [prompt] * b, cfg, tables, beam_size=BEAM_K,
            sample_len=n_step, compute_dtype=qeng.compute_dtype))
        _, t_greedy = _timed(lambda: decode_window(
            qeng.params, xa, [prompt] * b, cfg, tables, dataclasses.replace(
                opts, beam_size=None, sample_len=n_step),
            compute_dtype=qeng.compute_dtype))
        per_step[b] = (t_beam * 1e3 / n_step, t_greedy * 1e3 / n_step)
    rung = GREEDY_RUNG.get("wall")
    log(f"[beam] {card}: ms per step over {n_step} steps (prefill and "
        f"cross-KV projection included): beam {BEAM_K} at B=1 ({BEAM_K} "
        f"rows) {per_step[1][0]:.2f}, greedy B=1 {per_step[1][1]:.2f}; beam "
        f"at B=8 ({8 * BEAM_K} rows) {per_step[8][0]:.2f}, greedy B=8 "
        f"{per_step[8][1]:.2f}; [serve]'s profiled greedy rung "
        + (f"{rung * 1e3 / 224:.2f} ms per step (224 steps, encoder "
           f"included)" if rung else "not measured"))

    log(f"[beam] {card}: one step's parts alone at B=8 ({8 * BEAM_K} rows, "
        f"CUDA graph): {beam_parts_ms(cfg, 8)}")

    # --- the unquantized file path: K3 -------------------------------------
    reset_counts()
    ok &= _transcribe_one(eng, "en-12s beam 5", speech_like_audio(
        12.0, seed=21), card, opts)
    torch.cuda.synchronize()
    c = read_counts()
    want = n_enc * c["batches"]
    k3_ok = (c["batches"] > 0 and c["K3"] == want and no_knob_kernels(c)
             and c["K1"] == c["K9"] == c["K2"] == 0
             and c["K4"] == c["K5"] == c["K6"] == 0
             and any(k[0] == "grouped" for k in c["forwards"]))
    log(f"[beam] {card}: unquantized bf16 transcribe at beam {BEAM_K}: "
        f"launches {_launch_summary(c)} (want K3 = {n_enc} x {c['batches']} "
        f"= {want}, no other attention kernel) -> "
        f"{'PASS' if k3_ok else 'FAIL'}")
    ok &= k3_ok
    launches["K3"] = c["K3"]

    # --- the decode knobs on beam batches ----------------------------------
    def knob_batch(b, names, n=16):
        reset_counts()
        with knobs(names):
            out = beam_decode_window(
                qeng.params, xa8[:b], [prompt] * b, cfg, tables,
                beam_size=BEAM_K, sample_len=n,
                compute_dtype=qeng.compute_dtype)
            torch.cuda.synchronize()
        return out, read_counts()

    out, c = knob_batch(2, ("NWT_XATTN_KERNEL",))
    fw = c["forwards"]
    x_ok = (c["K4"] == 0 and bool(fw) and {k[0] for k in fw} == {"grouped"}
            and all(_beam_check(r, 16) for r in out))
    log(f"[beam] {card}: NWT_XATTN_KERNEL=1, one beam batch at B=2: decoder "
        f"forwards {fw}; K4 {c['K4']} (want 0: grouped forwards never take "
        f"K4) -> {'PASS' if x_ok else 'FAIL'}")
    ok &= x_ok
    k6 = 0
    for b in (1, 8):
        out, c = knob_batch(b, ("NWT_Q8_KERNEL_MIN_BYTES",))
        pred = predicted_decode_launches(c["forwards"], n_dec)
        side = "K6-decode" if b == 1 else "K6"
        this = (c["K6"] == pred["K6"] and c["K6-decode"] == pred["K6-decode"]
                and c[side] - (c["K6-decode"] if b == 8 else 0) > 0
                and c["K4"] == c["K5"] == 0
                and all(_beam_check(r, 16) for r in out))
        log(f"[beam] {card}: NWT_Q8_KERNEL_MIN_BYTES=1, one beam batch at "
            f"B={b} ({b * BEAM_K} rows a step): decoder forwards "
            f"{c['forwards']}; K6 {c['K6']} of which decode kernel "
            f"{c['K6-decode']}, prefill kernel {c['K6'] - c['K6-decode']} "
            f"(want {pred['K6']}, decode {pred['K6-decode']}) -> "
            f"{'PASS' if this else 'FAIL'}")
        ok &= this
        k6 += c["K6"]
    launches["K6"] = k6

    # --- NWT_BEAM_ANCESTRY --------------------------------------------------
    def run8():
        return beam_decode_window(qeng.params, xa8, [prompt] * 8, cfg,
                                  tables, beam_size=BEAM_K, sample_len=n_step,
                                  compute_dtype=qeng.compute_dtype)
    base, t_perm = _timed(run8)
    with knobs(("NWT_BEAM_ANCESTRY",)):
        anc, t_anc = _timed(run8)
    share = np.mean([a.tokens == p.tokens for a, p in zip(anc, base)])
    anc_ok = all(_beam_check(r, n_step) for r in anc)
    log(f"[beam] {card}: NWT_BEAM_ANCESTRY=1 on one B=8 batch ({n_step} "
        f"steps): {share:.3f} of the rows give the permuted run's tokens; "
        f"{t_anc * 1e3 / n_step:.2f} ms per step vs {t_perm * 1e3 / n_step:.2f}"
        f" permuted; results well formed -> {'PASS' if anc_ok else 'FAIL'}")
    ok &= anc_ok
    del xa8
    torch.cuda.empty_cache()

    walls = [f"{n}:{dt:.2f}" for n, dt in batch_walls]
    log(f"[beam] {card}: beam {BEAM_K}, rows a step {rows} (B x K), steps "
        f"{steps} over the serving path, ms per step {per_step[1][0]:.2f} "
        f"(B=1) {per_step[8][0]:.2f} (B=8), wall per batch (rows:s) "
        f"{walls}, idle share {idle:.3f}, launches {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s -> {'PASS' if ok else 'FAIL'}")
    return ok, launches


def _children(pid):
    """PIDs whose parent is ``pid`` (Linux /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _http(base, path, data=None, timeout=120):
    import json as _json
    import urllib.request
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, _json.loads(r.read())


ROUTER_RESTART_S = 60.0


def phase_router(card):
    """``python -m nobs_whisper_torch.cli route`` in a subprocess over two
    ``--manage`` backends, each ``python -m nobs_whisper_torch.cli serve
    --device cuda`` on the CLI phase's tiny dh=64 checkpoint (``--batch 4
    --warmup --sample-len 32 --temperature-increment 0``), with
    ``--restart-interval-s`` 60: both backends fall due together, the
    manager rolls the first, and the phase stops the router within the
    manager's 5 s poll after that roll, so exactly one roll happens.

    * ``/health`` aggregates both backends, loaded;
    * two push-to-talk sessions through the router land on different
      backends (least-loaded) and reach ``done``; a ``/ws`` session tunnels
      to its owner and gets its stop reply and ``done``;
    * two one-shot ``POST /transcribe`` round-robin over both backends
      (each backend's ``/stats`` "mel" stage counts one), the second with
      ``?beam_size=3``, both 200;
    * a session created before the roll (on the first backend, which the
      roll takes first) stays live while its backend drains, then stops
      and reaches ``done``; the backend is respawned and rejoins, and
      ``/backends`` shows ``restarts`` 1 on it and 0 on the other;
    * SIGINT: the router exits 0 within 60 s and no backend process it
      spawned (before or after the roll) is left.
    Any failure fails the phase."""
    import shutil
    import signal
    import tempfile
    from nobs_whisper_torch.client import Client
    from nobs_whisper_torch.utils.testing import speech_like_audio
    root = os.path.dirname(os.path.abspath(__file__))
    home = tempfile.mkdtemp(prefix="nwt-route-")
    model = os.path.join(home, "ggml-tiny-dh64.bin")
    write_cli_checkpoint(model)
    ports = [_free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports[:2]]
    base = f"http://127.0.0.1:{ports[2]}"
    cmd = [sys.executable, "-m", "nobs_whisper_torch.cli", "route",
           "--backends", ",".join(urls), "--port", str(ports[2]),
           "--restart-interval-s", str(ROUTER_RESTART_S),
           "--log-dir", os.path.join(home, "logs")]
    for p in ports[:2]:
        cmd += ["--manage", f"{sys.executable} -m nobs_whisper_torch.cli serve "
                f"--device cuda --model {model} --batch 4 --warmup "
                f"--sample-len 32 --temperature-increment 0 --port {p}"]
    env = dict(os.environ, NOBS_WHISPER_TPU_HOME=home)
    t_phase = time.perf_counter()
    route_log = open(os.path.join(home, "route.log"), "w+")
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=route_log,
                            stderr=subprocess.STDOUT)
    spawned, ok, rc, gap, rolled = set(), False, None, float("nan"), None
    placements = []
    try:
        deadline = time.monotonic() + 240
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                h = _http(base, "/health", timeout=10)[1]["backends"]
                if len(h) == 2 and all(v.get("loaded") for v in h.values()):
                    health = h
                    break
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.5)
        t_up = time.perf_counter() - t_phase
        assert health is not None, "the cluster never got healthy"
        spawned.update(_children(proc.pid))
        assert len(spawned) == 2, spawned
        log(f"[router] {card}: two backends healthy through the router "
            f"{t_up:.1f} s after launch (each warmed): /health {health}")

        # two push-to-talk sessions (least-loaded: one on each backend) and
        # a WebSocket session
        client = Client(base, timeout=600)
        s1 = client.session(language="en", sample_rate=16000)
        s2 = client.session(language="en", sample_rate=16000)
        placements = [b["sessions"] for b in _http(base, "/backends")[1]]
        assert placements == [1, 1], placements
        out = {}
        runs = [threading.Thread(target=_session_run, args=(
            base, name, speech_like_audio(4.0, seed=31 + i), 16000, out),
            kwargs=dict(session=s)) for i, (name, s) in
            enumerate((("ptt-0", s1), ("ptt-1", s2)))]
        runs.append(threading.Thread(target=_ws_run, args=(
            base, "ws", speech_like_audio(3.0, seed=33), 16000, out)))
        for th in runs:
            th.start()
        for th in runs:
            th.join(timeout=300)
        for name in ("ptt-0", "ptt-1", "ws"):
            r = out[name]
            states = [ev.state for _, ev in r["events"]]
            assert states and states[-1] == "done", (name, states)
            assert isinstance(r["final"], str), (name, r["final"])
        assert out["ws"]["replies"]["stop"]["reply"] == "stop"
        log(f"[router] {card}: sessions ptt-0, ptt-1 placed {placements} "
            f"(one a backend), ws tunnelled; all reached done")

        # two one-shots: round-robin, the second at beam 3
        pcm = speech_like_audio(2.0, seed=34).astype("<f4").tobytes()

        def mel_counts():
            st = _http(base, "/stats")[1]["backends"]
            return [st[u]["stages"].get("mel", {}).get("count", 0)
                    for u in urls]
        before = mel_counts()
        for q in ("language=en", "language=en&beam_size=3"):
            code, body = _http(base, "/transcribe?" + q, data=pcm)
            assert code == 200 and isinstance(body["text"], str), (q, code)
        spread = [a - b for a, b in zip(mel_counts(), before)]
        assert spread == [1, 1], spread
        log(f"[router] {card}: one-shots (greedy, then ?beam_size=3) both "
            f"200, one on each backend {spread}")

        # a session live across the roll
        live = client.session(language="en", sample_rate=16000)
        owner = [b["sessions"] for b in _http(base, "/backends")[1]]
        assert owner == [1, 0], owner
        events = live.events(timeout=600)
        live.start()
        got = []
        reader = threading.Thread(target=lambda: got.extend(events),
                                  daemon=True)
        reader.start()
        chunk = speech_like_audio(0.5, seed=35)
        t_wait = time.monotonic() + ROUTER_RESTART_S + 60
        draining = False
        while time.monotonic() < t_wait and not draining:
            live.push_audio(chunk)
            time.sleep(0.5)
            draining = _http(base, "/backends")[1][0]["draining"]
        assert draining, "the roll never started"
        t_drain = time.perf_counter()
        live.push_audio(chunk)
        final = live.stop()
        reader.join(timeout=120)
        assert got and got[-1].state == "done", [e.state for e in got]
        live.delete()
        t_done = time.perf_counter()
        t_wait = time.monotonic() + 240
        listing = None
        while time.monotonic() < t_wait:
            listing = _http(base, "/backends")[1]
            if listing[0]["restarts"] >= 1 and not listing[0]["draining"]:
                break
            time.sleep(0.25)
        rolled = time.perf_counter()
        gap = rolled - t_done
        assert [b["restarts"] for b in listing] == [1, 0], listing
        spawned.update(_children(proc.pid))
        assert len(spawned) == 3, spawned
        log(f"[router] {card}: live session stopped while its backend drained"
            f" ({time.perf_counter() - t_drain:.2f} s drain to rejoin), "
            f"final transcript {len(final or '')} chars, states "
            f"{[e.state for e in got][-3:]}; backend respawned and back in "
            f"{gap:.2f} s; /backends restarts "
            f"{[b['restarts'] for b in listing]}")

        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        ok = rc == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        route_log.seek(0)
        tail = route_log.read()[-3000:]
        route_log.close()
        left = [k for k in spawned if _alive(k)]
        for k in left:
            os.kill(k, signal.SIGKILL)
        shutil.rmtree(home, ignore_errors=True)
        if not ok:
            log(f"[router] route output: {tail}")
    ok = ok and not left
    log(f"[router] {card}: backends 2, placements {placements}, roll gap "
        f"{gap:.2f} s (session done to rejoin), exit {rc} on SIGINT, "
        f"spawned {len(spawned)} backend processes, left {len(left)}; phase "
        f"wall {time.perf_counter() - t_phase:.1f} s -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# [speculative] and [words]
# ---------------------------------------------------------------------------

SPEC_K, SPEC_POOL = 3, 4
DRAFT_MODEL = "distil-large-v3"   # shares turbo's width and vocabulary
SPEC_WAIT_MS = 250     # one wave, one batch: both engines batch alike
WORD_TOL = 1e-4        # golden alignment scores, card vs CPU, f32


def _eager_steps(impl):
    """``decode/greedy.py::decode_window_impl`` with its steps run eagerly:
    a step replayed from its CUDA graph calls no ``decoder_forward`` that
    a tap could see (the graph gives the eager loop's bits,
    ``tests/test_torch_decode_graph_gpu.py``)."""
    def eager(*a, **kw):
        return impl(*a, **{**kw, "cuda_graph": False})
    return eager


class LogitTap:
    """Keeps the logits (on the card) of every TARGET decoder forward that
    the greedy and speculative loops run while it is installed: the calls
    on a packed or int8 cross-KV (a dict), which at bf16 are all the
    target's; the draft's forwards (plain, pooled cross-KV) and the
    language-detect forward (plain) are left out. The greedy loop runs its
    steps eagerly meanwhile (:func:`_eager_steps`). A record: (tokens
    (B, S), pos_base or None, pad_lens, logits (B, S, V) f32)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from nobs_whisper_torch.decode import greedy, speculative
        self.saved = [(m, m.decoder_forward) for m in (greedy, speculative)]
        for m, fn in self.saved:
            m.decoder_forward = self._wrap(fn)
        self.saved_impl = greedy.decode_window_impl
        greedy.decode_window_impl = _eager_steps(self.saved_impl)
        return self

    def __exit__(self, *exc):
        from nobs_whisper_torch.decode import greedy
        for m, fn in self.saved:
            m.decoder_forward = fn
        greedy.decode_window_impl = self.saved_impl

    def _wrap(self, fn):
        def tapped(params, tokens, cache_start, pad_lens, kv_cache, cross_kv,
                   *a, **kw):
            out = fn(params, tokens, cache_start, pad_lens, kv_cache,
                     cross_kv, *a, **kw)
            if isinstance(cross_kv[0], dict):
                self.calls.append((tokens, kw.get("pos_base"), pad_lens,
                                   out[0]))
            return out
        return tapped

    def segments(self):
        """The records split by decode (one a batch): a decode starts at
        its prefill, a multi-token forward without ``pos_base``."""
        segs = []
        for rec in self.calls:
            if rec[1] is None and rec[0].shape[1] > 1:
                segs.append([])
            segs[-1].append(rec)
        return segs


def _emitted(res, eot, sample_len):
    """A window result's emitted tokens, its stop token included."""
    return res.tokens + ([eot] if len(res.tokens) < sample_len else [])


def near_tie(plain, spec, eot, sample_len):
    """Hold one row of a speculative decode against the same row of the
    sequential one. ``plain``/``spec``: (result, tap segment, row).

    D is the largest |logit difference| between the two runs' target
    forwards at every emission position where both consumed the same
    prefix (for the speculative run: the verify or tail position whose
    consumed drafts are the emitted tokens), up to and including the first
    position where the tokens differ. There, the sequential run's gap
    between its token and the speculative run's token (>= its top-2 gap)
    must lie within D. Returns (equal, first difference, gap, D)."""
    import torch
    (pr, pseg, prow), (sr, sseg, srow) = plain, spec
    g, s = _emitted(pr, eot, sample_len), _emitted(sr, eot, sample_len)
    first = next((i for i, (a, b) in enumerate(zip(g, s)) if a != b), None)
    limit = first if first is not None else len(g) - 1
    pe = [pseg[0][3][prow, -1]] + [rec[3][prow, 0] for rec in pseg[1:]]
    p_max = sseg[0][0].shape[1]
    diffs = [(sseg[0][3][srow, -1] - pe[0]).abs().amax()]
    for toks, pos_base, pad, logits in sseg[1:]:
        n = int(pos_base[srow]) - p_max + int(pad[srow]) + 1
        t = toks[srow].tolist()
        for j in range(toks.shape[1]):
            e = n + j
            if e > limit or t[1:j + 1] != s[n:e]:
                break
            diffs.append((logits[srow, j] - pe[e]).abs().amax())
    d = float(torch.stack(diffs).max())
    if first is None:
        return True, None, None, d
    lg = pe[first]
    return False, first, float(lg[g[first]] - lg[s[first]]), d


def _batch_log(batcher):
    """Wrap the batcher's ``_run_batch``: record each batch's rows (a hash
    of the row's frames or mel and its prompt) and results, in order."""
    import hashlib
    run = batcher._run_batch
    seen = []

    def recorded(batch):
        keys = [hashlib.sha1((r.frames if r.frames is not None else r.mel)
                             .tobytes() + bytes(str(r.prompt), "ascii"))
                .hexdigest() for r in batch]
        run(batch)
        seen.append((keys, [r.future.result() for r in batch]))

    batcher._run_batch = recorded
    return seen


def compare_runs(plain, spec, eot, sample_len, n_text_ctx):
    """Hold every row of the speculative run's batches against the same
    row (same audio and prompt) of the sequential run's. ``plain``/
    ``spec``: (batch log, tap segments); a batch decodes at most
    ``sample_len`` tokens and no more than its prompt width leaves of
    ``n_text_ctx``. Returns (equal rows, near-ties [(row, first
    difference, gap, D)], rows not comparable, failures, largest D)."""
    (pbatches, psegs), (sbatches, ssegs) = plain, spec
    where = {k: (bi, ri) for bi, (keys, _) in enumerate(pbatches)
             for ri, k in enumerate(keys)}
    equal, ties, apart, bad, d_max = 0, [], 0, [], 0.0
    for bi, (keys, results) in enumerate(sbatches):
        for ri, k in enumerate(keys):
            if k not in where:       # its prompt follows an earlier tie
                apart += 1
                continue
            pbi, pri = where[k]
            p_max = ssegs[bi][0][0].shape[1]
            same, first, gap, d = near_tie(
                (pbatches[pbi][1][pri], psegs[pbi], pri),
                (results[ri], ssegs[bi], ri), eot,
                min(sample_len, n_text_ctx - p_max))
            d_max = max(d_max, d)
            if same:
                equal += 1
            elif gap <= d:
                ties.append((f"{bi}.{ri}", first, gap, d))
            else:
                bad.append((f"{bi}.{ri}", first, gap, d))
    return equal, ties, apart, bad, d_max


def _tie_line(equal, ties, apart, bad, d_max):
    ok = not bad and equal + len(ties) > 0
    return ok, (f"rows equal {equal}, near-ties {len(ties)} "
                + "".join(f"[row {r} from token {e}: gap {g:.4f} <= D "
                          f"{d:.4f}] " for r, e, g, d in ties)
                + f"not comparable {apart}, failing {len(bad)} "
                + "".join(f"[row {r} from token {e}: gap {g:.4f} > D "
                          f"{d:.4f}] " for r, e, g, d in bad)
                + f"(largest D {d_max:.4f})")


def _direct_pair(qeng, xa, prompts, tables, opts, **spec):
    """The sequential and the speculative decode of one batch of encoder
    states, both tapped: ((batch log, segments), ...) as compare_runs
    takes them, and the speculative handle's pass count."""
    import hashlib
    from nobs_whisper_torch.decode import greedy
    keys = [hashlib.sha1(bytes(str(i), "ascii")).hexdigest()
            for i in range(len(prompts))]
    out = []
    for kw in ({}, spec):
        with LogitTap() as tap:
            h = greedy.decode_window_dispatch(
                qeng.params, xa, prompts, qeng.cfg, tables, opts,
                compute_dtype=qeng.compute_dtype, **kw)
            res = greedy.decode_window_finalize(h)
        out.append(([(keys, res)], tap.segments()))
    return out[0], out[1], h.passes


def reference_speculative(dev):
    """Speculative greedy on small models on the card, f32 with TF32 off:
    the golden model's tokens (K = 1 and 3, pool 1 and 2) equal its golden
    greedy ``tokens``; a d=128 dh=64 int8 model's speculative tokens and
    pass counts on the card equal its CPU run's (three windows)."""
    import numpy as np
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.decode.speculative import decode_window_speculative
    from nobs_whisper_torch.models import whisper as mw
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    z, params, cfg = _load_goldens(dev)
    tables = build_rule_tables(cfg, DecodeOptions(suppress_blank=True))
    xa = torch.from_numpy(z["xa"]).to(dev)
    want = z["greedy_tokens"].tolist()
    ok = True
    for k, pool in ((1, 1), (1, 2), (3, 1), (3, 2)):
        res, passes = decode_window_speculative(
            params, xa, [z["prompt"].tolist()], cfg, tables, k_draft=k,
            draft_pool=pool, return_passes=True)
        this = res[0].tokens == want
        log(f"[reference] speculative K={k} pool {pool} on the f32 golden "
            f"model: tokens {len(res[0].tokens)} equal the golden greedy "
            f"tokens {this}, passes {passes} -> {'PASS' if this else 'FAIL'}")
        ok &= this

    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=160, n_text_ctx=64)
    params = quantize_decoder_params(mw.init_params(DEC_SEED, cfg))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    xa = torch.from_numpy(np.random.RandomState(6).randn(
        3, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    prompts = [[cfg.sot, cfg.lang_base + i, cfg.transcribe]
               for i in range(3)]
    tables = build_rule_tables(cfg, DecodeOptions())
    got, p_got = decode_window_speculative(
        to_dev(params), xa.to(dev), prompts, cfg, tables, k_draft=3,
        draft_pool=4, return_passes=True)
    ref, p_ref = decode_window_speculative(
        params, xa, prompts, cfg, tables, k_draft=3, draft_pool=4,
        return_passes=True)
    same = [r.tokens for r in got] == [r.tokens for r in ref] \
        and p_got == p_ref
    log(f"[reference] speculative K=3 pool 4 on a d=128 dh=64 int8 model at "
        f"f32, three windows, card vs CPU: tokens {[len(r.tokens) for r in got]}"
        f" equal {same}, passes {p_got} vs {p_ref} -> "
        f"{'PASS' if same else 'FAIL'}")
    return ok and same


def phase_speculative(card, qeng, eng):
    """Exact speculative greedy on the card at large-v3-turbo's width, the
    int8 engine ``qeng``, self-draft over 4x pooled cross-KV, K=3, ladder
    off; counts set to 0 just before each path and read just after it.

    * the serving path: ``BatchedEngine(qeng, max_batch=8,
      speculative=3)``, one wave of five fixed-language windows and one
      auto-language window, then a 45 s long-form request; the same
      requests through the non-speculative ``BatchedEngine`` (both collect
      for 250 ms, so that a wave is one batch in each). Every row's tokens
      equal the sequential run's or differ by a near-tie
      (:func:`near_tie`). K1 = K2 = 32 x encoder batches, K4 = K5 = K6 =
      0; ``emitted_per_pass`` by ``/stats``'s formula;
    * under ``NWT_Q8_KERNEL_MIN_BYTES=1`` one batch at B=1 and one at B=8:
      K6's decode-kernel and prefill-kernel launches as the gates predict
      from the draft, verify and tail forwards run;
    * a second-model draft, ``from_random("distil-large-v3")`` quantized:
      one batch at B=4 held by the near-tie rule; then one batch under
      ``NWT_XATTN_KERNEL=1`` (K4 once a layer in each tail forward, none
      on draft or verify forwards) and one on int8 cross-KV under
      ``NWT_Q8_KV_PALLAS=1`` (K5 the same way), both with this draft,
      whose low acceptance runs the tail; ``distil-small.en`` is refused
      (``draft model incompatible``);
    * a perfect self-draft (pool 1): the pass count;
    * ms per emitted token, speculative and greedy on the same encoder
      states, at B=1 and B=8 (96 tokens);
    * one request under ``torch.profiler`` (64 tokens): the idle share."""
    import types
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core.config import get_config
    from nobs_whisper_torch.decode import greedy
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = qeng.cfg
    n_enc, n_dec = cfg.n_audio_layer, cfg.n_text_layer
    sample_len = cfg.n_text_ctx // 2
    eot = cfg.eot
    opts = DecodeOptions(temperature_increment=0.0)
    t_phase = time.perf_counter()
    launches = {}
    wave = _beam_wave() + [("longform-45s", speech_like_audio(45.0, seed=8),
                            "en")]

    # --- the serving path, speculative and sequential -----------------------
    runs = {}
    for name, kw in (("speculative", dict(speculative=SPEC_K,
                                          draft_pool=SPEC_POOL)),
                     ("sequential", {})):
        be = BatchedEngine(qeng, opts=opts, max_batch=8,
                           max_wait_ms=SPEC_WAIT_MS, **kw)
        batches = _batch_log(be.batcher)
        try:
            reset_counts()
            with LogitTap() as tap:
                t0 = time.perf_counter()
                ok_w = _run_wave(be, wave[:-1], card)
                ok_w &= _run_wave(be, wave[-1:], card)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            c = read_counts()
        finally:
            be.close()
        runs[name] = (batches, tap.segments(), c, wall, ok_w,
                      list(be.batcher.spec_stats), be.batcher.batch_sizes)
    sb, ss, c, wall, ok, stats, sizes = runs["speculative"]
    pb, ps, _, p_wall, p_ok, _, p_sizes = runs["sequential"]
    ok &= p_ok
    aligned = len(ss) == len(sb) and len(ps) == len(pb)
    tie_ok, tie_line = _tie_line(*compare_runs(
        (pb, ps), (sb, ss), eot, sample_len, cfg.n_text_ctx))
    del runs, ss, ps
    torch.cuda.empty_cache()
    batches_n = c["batches"]
    want = n_enc * batches_n
    counts_ok = (batches_n > 0 and c["K1"] == c["K2"] == want
                 and c["K3"] == c["K9"] == c["K2-f32"] == 0
                 and c["K4"] == c["K5"] == c["K6"] == 0
                 and no_knob_kernels(c))
    emitted = sum(e for _, _, e in stats)
    pass_rows = sum(p * r for p, r, _ in stats)
    epp = emitted / max(pass_rows, 1)
    log(f"[speculative] {card}: serving wall {wall:.2f} s (sequential "
        f"{p_wall:.2f} s); batch sizes {sizes} (sequential {p_sizes}); "
        f"encoder batches {batches_n}; launches {_launch_summary(c)} (want "
        f"K1 = K2 = {n_enc} x {batches_n} = {want}, K4 = K5 = K6 = 0); "
        f"spec_stats (passes, rows, emitted) {stats}: emitted_per_pass "
        f"{epp:.3f} -> {'PASS' if counts_ok and ok else 'FAIL'}")
    log(f"[speculative] {card}: served rows against the sequential run: "
        f"{tie_line}; taps aligned {aligned} -> "
        f"{'PASS' if tie_ok and aligned else 'FAIL'}")
    ok &= counts_ok and tie_ok and aligned and bool(stats)
    launches.update(K1=c["K1"], K2=c["K2"])

    # --- direct batches ----------------------------------------------------
    prompt = qeng.tokenizer.sot_sequence(language="en")
    tables = build_rule_tables(cfg, opts, qeng.tokenizer, device=qeng.device)
    xa8 = _windows_xa(qeng, 8, seed=60)

    def batch(b, n, names=(), q8=False, **kw):
        o = DecodeOptions(sample_len=n, temperature_increment=0.0,
                          q8_cross_kv=q8)
        reset_counts()
        with knobs(names):
            h = greedy.decode_window_dispatch(
                qeng.params, xa8[:b], [prompt] * b, cfg, tables, o,
                compute_dtype=qeng.compute_dtype, speculative=SPEC_K, **kw)
            res = greedy.decode_window_finalize(h)
            torch.cuda.synchronize()
        return res, h.passes, read_counts()

    def phases(fw):
        return {k: sum(n for key, n in fw.items() if pred(*key))
                for k, pred in (
                    ("draft", lambda lay, b, s: lay == "plain" and s == 1),
                    ("verify", lambda lay, b, s: lay != "plain"
                     and s == SPEC_K + 1),
                    ("tail", lambda lay, b, s: lay != "plain" and s == 1))}

    k6 = 0
    for b in (1, 8):
        _, passes, c = batch(b, 32, ("NWT_Q8_KERNEL_MIN_BYTES",))
        pred = predicted_decode_launches(c["forwards"], n_dec)
        this = (c["K6"] == pred["K6"] and c["K6-decode"] == pred["K6-decode"]
                and c["K6"] > 0 and c["K4"] == c["K5"] == 0)
        log(f"[speculative] {card}: NWT_Q8_KERNEL_MIN_BYTES=1, one batch at "
            f"B={b} (32 tokens, {passes} passes): forwards {phases(c['forwards'])}"
            f" {c['forwards']}; K6 {c['K6']} of which decode kernel "
            f"{c['K6-decode']}, prefill kernel {c['K6'] - c['K6-decode']} "
            f"(want {pred['K6']}, decode {pred['K6-decode']}) -> "
            f"{'PASS' if this else 'FAIL'}")
        ok &= this
        k6 += c["K6"]
    launches["K6"] = k6

    # the second-model draft: distil-large-v3's width and vocabulary
    t0 = time.perf_counter()
    distil = WhisperEngine.from_random(DRAFT_MODEL, seed=1,
                                       device=qeng.device).quantize()
    torch.cuda.synchronize()
    dr = (distil.params, distil.cfg)
    log(f"[speculative] {card}: draft {DRAFT_MODEL} (d="
        f"{distil.cfg.n_text_state}, {distil.cfg.n_text_layer} decoder "
        f"layers, vocab {distil.cfg.n_vocab}), random weights from seed 1, "
        f"int8: built in {time.perf_counter() - t0:.1f} s")
    d_opts = DecodeOptions(sample_len=64, temperature_increment=0.0)
    seq, spec, passes = _direct_pair(qeng, xa8[:4], [prompt] * 4, tables,
                                     d_opts, speculative=SPEC_K, draft=dr)
    d_ok, d_line = _tie_line(*compare_runs(seq, spec, eot, 64,
                                           cfg.n_text_ctx))
    emitted = sum(len(_emitted(r, eot, 64)) for r in spec[0][0][1])
    log(f"[speculative] {card}: distil-large-v3 drafting, one batch at B=4 "
        f"(64 tokens): {passes} passes, emitted_per_pass "
        f"{emitted / (passes * 4):.3f}; {d_line} -> "
        f"{'PASS' if d_ok else 'FAIL'}")
    ok &= d_ok
    del seq, spec
    for key, names, q8 in (("K4", ("NWT_XATTN_KERNEL",), False),
                           ("K5", ("NWT_Q8_KV_PALLAS",), True)):
        _, passes, c = batch(2, 32, names, q8=q8, draft=dr)
        ph = phases(c["forwards"])
        pred = predicted_decode_launches(c["forwards"], n_dec)
        this = (c[key] == pred[key] == n_dec * ph["tail"] and ph["tail"] > 0
                and c["K6"] == 0 and c["K4" if key == "K5" else "K5"] == 0)
        log(f"[speculative] {card}: {names[0]}=1"
            f"{' on int8 cross-KV' if q8 else ''}, distil draft, one batch "
            f"at B=2 (32 tokens, {passes} passes): forwards {ph} "
            f"{c['forwards']}; {key} {c[key]} (want {n_dec} x tail "
            f"forwards {ph['tail']} = {n_dec * ph['tail']}, none on draft "
            f"and verify forwards) -> {'PASS' if this else 'FAIL'}")
        ok &= this
        launches[key] = c[key]
    del distil, dr
    torch.cuda.empty_cache()
    small = types.SimpleNamespace(params=None,
                                  cfg=get_config("distil-small.en"))
    try:
        BatchedEngine(qeng, speculative=SPEC_K, draft_engine=small).close()
        msg = "not refused"
    except ValueError as e:
        msg = str(e)
    r_ok = msg.startswith("draft model incompatible")
    log(f"[speculative] {card}: distil-small.en as the draft: {msg} -> "
        f"{'PASS' if r_ok else 'FAIL'}")
    ok &= r_ok

    # --- a perfect self-draft, and ms per emitted token --------------------
    res, passes, _ = batch(8, 96, draft_pool=1)
    emitted = sum(len(_emitted(r, eot, 96)) for r in res)
    log(f"[speculative] {card}: perfect self-draft (pool 1), B=8, 96 tokens: "
        f"{passes} passes for {emitted} tokens, emitted_per_pass "
        f"{emitted / (passes * 8):.3f}")
    o96 = DecodeOptions(sample_len=96, temperature_increment=0.0)

    def decode(b, **kw):
        h = greedy.decode_window_dispatch(
            qeng.params, xa8[:b], [prompt] * b, cfg, tables, o96,
            compute_dtype=qeng.compute_dtype, **kw)
        return greedy.decode_window_finalize(h), (h.passes if kw else None)

    per_tok = {}
    for b in (1, 8):
        timed = {}
        for name, kw in (("greedy", {}), ("speculative",
                                          dict(speculative=SPEC_K,
                                               draft_pool=SPEC_POOL))):
            (res, n_pass), dt = _timed(lambda: decode(b, **kw))
            # a row's emitted tokens: ms per token as one stream sees it
            n_tok = sum(len(_emitted(r, eot, 96)) for r in res) / b
            timed[name] = (dt * 1e3 / n_tok, n_pass)
        per_tok[b] = timed
    log(f"[speculative] {card}: ms per emitted token (a row's; 96 tokens, "
        f"prefill and cross-KV included; speculative K={SPEC_K} pool "
        f"{SPEC_POOL}): B=1 speculative {per_tok[1]['speculative'][0]:.2f} "
        f"({per_tok[1]['speculative'][1]} passes) vs greedy "
        f"{per_tok[1]['greedy'][0]:.2f}; B=8 speculative "
        f"{per_tok[8]['speculative'][0]:.2f} "
        f"({per_tok[8]['speculative'][1]} passes) vs greedy "
        f"{per_tok[8]['greedy'][0]:.2f}")
    del xa8
    torch.cuda.empty_cache()

    # --- one request under the profiler -------------------------------------
    one = BatchedEngine(qeng, opts=DecodeOptions(
        sample_len=64, temperature_increment=0.0), max_batch=8,
        speculative=SPEC_K, draft_pool=SPEC_POOL)
    idle = float("nan")
    try:
        req = _request_audio()[0][1]               # en-12s, as in [serve]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _run_wave(one, [req], card)
            torch.cuda.synchronize()
            p_wall = time.perf_counter() - t0
        ka = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        busy = sum(getattr(e, attr) for e in ka) / 1e6
        idle = max(0.0, 1 - busy / p_wall)
        top = sorted(ka, key=lambda e: -getattr(e, attr))[:6]
        prof_line = (f"wall {p_wall:.3f} s, device busy {busy:.3f} s, idle "
                     f"share {idle:.3f}; passes {one.batcher.spec_stats}; "
                     "largest device rows: " + "; ".join(
                         f"{getattr(e, attr) / 1e3:.2f} ms {e.count}x "
                         f"{e.key[:60]}" for e in top))
    except Exception as e:          # reported, not fatal: a measurement
        prof_line = f"not measured: {e!r}"
    finally:
        one.close()
    log(f"[speculative] {card}: profiled request (en-12s, 64 tokens): "
        f"{prof_line}")
    log(f"[speculative] {card}: launches {launches}, emitted_per_pass "
        f"{epp:.3f}, idle share {idle:.3f}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok, launches


class WordSpy:
    """Records each window's text tokens and its words (the list that
    ``transcribe_mel`` then merges and refines in place) while installed
    over ``decode/timing.py::find_word_timings``."""

    def __enter__(self):
        from nobs_whisper_torch.decode import timing
        self.mod, self.real, self.windows = timing, timing.find_word_timings, []

        def spy(params, cfg, tokenizer, xa, text_tokens, *a, **kw):
            words = self.real(params, cfg, tokenizer, xa, text_tokens, *a,
                              **kw)
            self.windows.append((list(text_tokens), words))
            return words

        timing.find_word_timings = spy
        return self

    def __exit__(self, *exc):
        self.mod.find_word_timings = self.real


def _words_check(r, windows, cfg):
    """A word-timestamp result is well formed: each window's words' tokens
    are its text tokens in order, the words start in order and end after
    they start, every segment carries its words, and each lies inside its
    segment. Returns (ok, words)."""
    words = [w for _, ws in windows for w in ws]
    concat = all([t for w in ws for t in w.tokens]
                 == [t for t in toks if t < cfg.eot] for toks, ws in windows)
    mono = all(b.start >= a.start - 1e-6 for a, b in zip(words, words[1:])) \
        and all(w.start <= w.end + 1e-6 for w in words)
    segs = r.segments
    inside = all(s.words is not None for s in segs) and all(
        s.start - 1e-6 <= w.start and w.end <= s.end + 1e-6
        for s in segs for w in s.words)
    return bool(words) and concat and mono and inside, words


def reference_words(dev):
    """The golden model on the card against the CPU at f32 (TF32 off): the
    alignment scores of its greedy tokens within ``WORD_TOL``, and the
    word boundaries equal. The goldens carry no tokenizer: a vocabulary in
    which every piece starts with a space makes each token a word, so
    every token's boundaries are compared."""
    import torch
    from nobs_whisper_torch.core.tokenizer import WhisperTokenizer
    from nobs_whisper_torch.decode.timing import (alignment_scores,
                                                  default_alignment_heads,
                                                  find_word_timings)
    cpu = torch.device("cpu")
    (z, p_dev, cfg), (_, p_cpu, _) = _load_goldens(dev), _load_goldens(cpu)
    tok = WhisperTokenizer([b" t%d" % i for i in range(cfg.eot)], cfg)
    prompt = z["prompt"].tolist()
    text = [t for t in z["greedy_tokens"].tolist() if t < cfg.eot]
    toks = torch.tensor([prompt + text + [cfg.eot]])
    heads = tuple(default_alignment_heads(cfg))
    xa = torch.from_numpy(z["xa"])
    got = alignment_scores(p_dev, toks.to(dev), xa.to(dev), cfg, heads)
    ref = alignment_scores(p_cpu, toks, xa, cfg, heads)
    err = (got.cpu() - ref).abs().max().item()
    words = [[(w.word, w.tokens, w.start, w.end) for w in find_word_timings(
        p, cfg, tok, x, text, prompt, num_frames=2 * cfg.n_audio_ctx)]
        for p, x in ((p_dev, xa.to(dev)), (p_cpu, xa))]
    ok = err <= WORD_TOL and words[0] == words[1] and bool(words[0])
    log(f"[words] alignment scores of the f32 golden model ({len(heads)} "
        f"heads x {toks.shape[1]} tokens x {cfg.n_audio_ctx}), card vs CPU: "
        f"max_abs_err {err:.3e} (tol {WORD_TOL}); words {len(words[0])}, "
        f"boundaries equal {words[0] == words[1]} -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok


def phase_words(card, qeng, eng):
    """Word timestamps on the card at large-v3-turbo's width (ladder off):
    ``transcribe`` of the 12 s clip with ``word_timestamps=True`` on the
    unquantized bf16 engine (K3 = 32 x encoder batches) and on the int8
    engine (K1 = K2 = 32 x encoder batches): words well formed
    (:func:`_words_check`); the golden model's alignment on the card
    against the CPU (:func:`reference_words`); one ``POST
    /transcribe?word_timestamps=1`` on the int8 serving path answers 200
    with words (its options are the server's defaults: the ladder runs)."""
    import json as _json
    import tempfile
    import urllib.request
    import torch
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import speech_like_audio

    t_phase = time.perf_counter()
    cfg = eng.cfg
    n_enc = cfg.n_audio_layer
    clip = speech_like_audio(12.0, seed=21)
    opts = DecodeOptions(word_timestamps=True, temperature_increment=0.0)
    ok, launches = True, {}
    for name, e, kern in (("unquantized bf16", eng, ("K3",)),
                          ("int8", qeng, ("K1", "K2"))):
        reset_counts()
        t0 = time.perf_counter()
        with WordSpy() as spy:
            r = e.transcribe(clip, language="en", opts=opts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = read_counts()
        w_ok, words = _words_check(r, spy.windows, cfg)
        want = n_enc * c["batches"]
        others = {"K1", "K2", "K3", "K9"} - set(kern)
        k_ok = (c["batches"] > 0 and all(c[k] == want for k in kern)
                and not any(c[k] for k in others)
                and c["K4"] == c["K5"] == c["K6"] == 0 and no_knob_kernels(c))
        log(f"[words] {card}: {name} transcribe of a 12 s clip with "
            f"word_timestamps: {dt:.2f} s, segments {len(r.segments)}, "
            f"windows {len(spy.windows)}, words {len(words)} (the first "
            f"three's bounds {[(w.start, w.end) for w in words[:3]]}), well "
            f"formed {w_ok}; launches {_launch_summary(c)} (want "
            f"{' = '.join(kern)} = {n_enc} x {c['batches']} = {want}) -> "
            f"{'PASS' if w_ok and k_ok else 'FAIL'}")
        ok &= w_ok and k_ok
        for k in kern:
            launches[k] = c[k]
    ok &= reference_words(qeng.device)

    tmp = tempfile.TemporaryDirectory(prefix="nwt-home-")
    old_home = os.environ.get("NOBS_WHISPER_TPU_HOME")
    os.environ["NOBS_WHISPER_TPU_HOME"] = tmp.name
    be = BatchedEngine(qeng, opts=DecodeOptions(temperature_increment=0.0),
                       max_batch=8)
    port = _free_port()
    httpd = serve(be, host="127.0.0.1", port=port, background=True)
    try:
        audio = speech_like_audio(5.0, seed=5)
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe?language=en"
            "&word_timestamps=1", data=audio.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, body = resp.status, _json.loads(resp.read())
        dt = time.perf_counter() - t0
        words = [w for s in body["segments"] for w in s["words"] or ()]
        s_ok = code == 200 and bool(words) and all(
            s["words"] is not None for s in body["segments"])
        log(f"[words] {card}: POST /transcribe?word_timestamps=1 (5 s, int8 "
            f"serving engine, the ladder on): {code} in {dt:.2f} s, segments "
            f"{len(body['segments'])}, words {len(words)} -> "
            f"{'PASS' if s_ok else 'FAIL'}")
        ok &= s_ok
    finally:
        httpd.shutdown()
        be.close()
        if old_home is None:
            os.environ.pop("NOBS_WHISPER_TPU_HOME", None)
        else:
            os.environ["NOBS_WHISPER_TPU_HOME"] = old_home
        tmp.cleanup()
    log(f"[words] {card}: launches {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok, launches


# ---------------------------------------------------------------------------
# [mesh] and [native]: the dp x tp mesh and the native snapshots
# ---------------------------------------------------------------------------

class MeshTap:
    """The last-position logits of every target decoder forward of the
    greedy loop (the calls on a packed or int8 cross-KV; the language
    detect forward is left out), by host thread: a mesh's shards decode
    in threads of their own (``parallel/spmd.py``, thread
    ``nwt-shard-<dp>-<tp>``), an unsharded batch in the batcher's, its
    steps run eagerly meanwhile (:func:`_eager_steps`)."""

    def __init__(self):
        self.calls = {}
        self._lock = threading.Lock()

    def __enter__(self):
        from nobs_whisper_torch.decode import greedy
        self.saved = greedy.decoder_forward
        greedy.decoder_forward = self._wrap(self.saved)
        self.saved_impl = greedy.decode_window_impl
        greedy.decode_window_impl = _eager_steps(self.saved_impl)
        return self

    def __exit__(self, *exc):
        from nobs_whisper_torch.decode import greedy
        greedy.decoder_forward = self.saved
        greedy.decode_window_impl = self.saved_impl

    def _wrap(self, fn):
        def tapped(params, tokens, cache_start, pad_lens, kv_cache, cross_kv,
                   *a, **kw):
            out = fn(params, tokens, cache_start, pad_lens, kv_cache,
                     cross_kv, *a, **kw)
            if isinstance(cross_kv[0], dict):
                with self._lock:
                    self.calls.setdefault(
                        threading.current_thread().name, []).append(
                            out[0][:, -1].float())
            return out
        return tapped


def greedy_near_tie(p_logits, s_logits, g, s):
    """Hold one row of a greedy decode against the same row of another
    greedy decode: ``p_logits``/``s_logits`` the row's logits at each
    emission, ``g``/``s`` the emitted tokens (stop token included). D is
    the largest |logit difference| of the two runs at every emission up to
    and including the first where the tokens differ; there, the first
    run's gap between its token and the other's must lie within D (the
    rule of ``near_tie``, for two sequential loops). Returns (equal, first
    difference, gap, D)."""
    first = next((i for i, (a, b) in enumerate(zip(g, s)) if a != b), None)
    if first is None and len(g) != len(s):
        first = min(len(g), len(s))
    limit = min(first if first is not None else len(g) - 1,
                len(p_logits) - 1, len(s_logits) - 1)
    d = max(float((s_logits[e].to(p_logits[e].device)
                   - p_logits[e]).abs().amax()) for e in range(limit + 1))
    if first is None:
        return True, None, None, d
    if first >= len(p_logits) or first >= len(g) or first >= len(s):
        return False, first, float("inf"), d
    lg = p_logits[first]
    return False, first, float(lg[g[first]] - lg[s[first]]), d


def _mesh_wave():
    """Eight fixed-language single-window requests of 5-28 s, sent at
    once (the batch of eight fills at once)."""
    from nobs_whisper_torch.utils.testing import speech_like_audio
    return [(f"en-{d}s", speech_like_audio(float(d), seed=60 + i), "en")
            for i, d in enumerate((5, 8, 12, 15, 18, 21, 25, 28))]


def _mesh_run(qeng, mesh, wave, opts):
    """One wave through ``BatchedEngine(qeng, max_batch=8, mesh=mesh)``,
    its batches logged and its decoder forwards tapped. Returns (batch
    log, tap, counts, wall s, batch sizes, ok)."""
    import torch
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    be = BatchedEngine(qeng, opts=opts, max_batch=8, max_wait_ms=3000,
                       mesh=mesh)
    try:
        batches = _batch_log(be.batcher)
        errors = []

        def one(name, audio, lang):
            try:
                be.transcribe(audio, language=lang)
            except Exception as e:   # reported below, fails the phase
                errors.append((name, repr(e)))

        reset_counts()
        t0 = time.perf_counter()
        with MeshTap() as tap:
            threads = [threading.Thread(target=one, args=w) for w in wave]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        for name, err in errors:
            log(f"[mesh] {name}: FAILED {err}")
        return batches, tap, c, wall, list(be.batcher.batch_sizes), \
            not errors
    finally:
        be.close()


def phase_mesh(card, qeng):
    """The dp x tp mesh on the card (``parallel/``), on the int8
    large-v3-turbo engine (random weights from seed 0, full width, bf16):

    * dp=2 through ``BatchedEngine(mesh=...)``: two cards when there are,
      else ``cuda:0`` twice (each shard in a host thread of its own under
      its device's context). A wave of eight framed requests (ladder off)
      fills one batch; every row's tokens equal the unsharded
      ``BatchedEngine``'s on the same requests under the near-tie rule
      (``greedy_near_tie``: each shard decodes 4 rows where the unsharded
      batch decodes 8, so matmul shapes and their bf16 roundings differ),
      and K1 and K2 launch shards x layers x batches times.
    * dp=1 x tp=2: one 30 s window encoded and decoded with each layer's
      heads and FFN columns split over two ranks (kernels off, as the
      reference's gates are under GSPMD): the encoder states within
      ``TP_TOL`` of the unsharded plain path (every gate off) and K1 = K2
      = 0; the decode (48 steps) held to the unsharded plain decode under
      the near-tie rule.
    * ``serve --mesh 1x1`` in a subprocess: up, one ``POST /transcribe``,
      exit 0 on SIGINT."""
    import dataclasses
    import tempfile

    import torch
    from nobs_whisper_torch.audio.mel import log_mel_longform
    from nobs_whisper_torch.decode.greedy import (decode_window_dispatch,
                                                  decode_window_finalize)
    from nobs_whisper_torch.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_torch.models.whisper import encode
    from nobs_whisper_torch.parallel.mesh import make_mesh
    from nobs_whisper_torch.parallel.spmd import encode_spmd
    from nobs_whisper_torch.parallel.tp import ShardContext, shard_context
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = qeng.cfg
    n_cards = torch.cuda.device_count()
    pair = (["cuda:0", "cuda:1"] if n_cards >= 2 else ["cuda:0", "cuda:0"])
    where = ("two cards, cuda:0 and cuda:1" if n_cards >= 2
             else "one card, cuda:0 twice")
    eot = cfg.eot
    opts = DecodeOptions(temperature_increment=0.0)
    sample_len = cfg.n_text_ctx // 2
    wave = _mesh_wave()
    ok = True

    plain = _mesh_run(qeng, None, wave, opts)
    dp2 = make_mesh(dp=2, devices=pair)
    mesh = _mesh_run(qeng, dp2, wave, opts)
    ok &= plain[5] and mesh[5]
    (pb, ptap, _, pwall, psizes, _), (mb, mtap, c, mwall, msizes, _) = \
        plain, mesh
    one_batch = len(pb) == 1 and len(mb) == 1
    equal, ties, bad, d_max = 0, [], [], 0.0
    if one_batch:
        pkeys, pres = pb[0]
        mkeys, mres = mb[0]
        prow = {k: i for i, k in enumerate(pkeys)}
        plog = ptap.calls.get("nwt-batch-run", [])
        half = -(-len(mkeys) // 2)        # rows a shard (the batch pads)
        for mi, k in enumerate(mkeys):
            pi = prow[k]
            slog = mtap.calls.get(f"nwt-shard-{mi // half}-0", [])
            same, first, gap, d = greedy_near_tie(
                [z[pi] for z in plog], [z[mi % half] for z in slog],
                _emitted(pres[pi], eot, sample_len),
                _emitted(mres[mi], eot, sample_len))
            d_max = max(d_max, d)
            if same:
                equal += 1
            elif gap <= d:
                ties.append((str(mi), first, gap, d))
            else:
                bad.append((str(mi), first, gap, d))
    tie_ok, line = _tie_line(equal, ties, 0, bad, d_max)
    tie_ok &= one_batch and equal + len(ties) == len(wave)
    shards_run = c["batches"]
    want = cfg.n_audio_layer * shards_run
    counts_ok = (shards_run == 2 * len(mb) and c["K1"] == want
                 and c["K2"] == want and c["K3"] == c["K9"] == 0
                 and c["K4"] == c["K5"] == c["K6"] == 0
                 and no_knob_kernels(c))
    log(f"[mesh] {card}: dp=2 on {where}: eight 5-28 s requests, batch "
        f"sizes unsharded {psizes} ({pwall:.2f} s) and dp=2 {msizes} "
        f"({mwall:.2f} s), ladder off; rows against the unsharded batch: "
        f"{line} -> {'PASS' if tie_ok else 'FAIL'}")
    log(f"[mesh] {card}: dp=2 launches K1 {c['K1']} K2 {c['K2']} (want "
        f"2 shards x {cfg.n_audio_layer} layers x {len(mb)} batches = "
        f"{want}; shard encodes {shards_run}) -> "
        f"{'PASS' if counts_ok else 'FAIL'}")
    ok &= tie_ok and counts_ok
    launches = {"K1": c["K1"], "K2": c["K2"]}

    # dp=1 x tp=2: one window, encoded and decoded over two ranks
    tp2 = make_mesh(dp=1, tp=2, devices=pair)
    audio = speech_like_audio(30.0, seed=71)
    mel = torch.from_numpy(log_mel_longform(
        audio, n_mels=cfg.n_mels, device="cuda")[:, :2 * cfg.n_audio_ctx]
    ).to("cuda")[None]
    reset_counts()
    t0 = time.perf_counter()
    xa_tp = encode_spmd(qeng.params, mel, tp2, cfg, qeng.compute_dtype)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    c = read_counts()
    with shard_context(ShardContext(None, plain=True)):
        xa_plain = encode(qeng.params, mel, cfg, qeng.compute_dtype)
    err = float((xa_tp.float() - xa_plain.float()).abs().max()
                / xa_plain.float().abs().max())
    finite = bool(torch.isfinite(xa_tp.float()).all())
    enc_ok = (finite and xa_tp.shape == (1, cfg.n_audio_ctx,
                                         cfg.n_audio_state)
              and err <= TP_TOL and c["K1"] == c["K2"] == 0)
    log(f"[mesh] {card}: dp=1 x tp=2 on {where}: encoder states "
        f"{tuple(xa_tp.shape)} in {enc_s:.2f} s, max |tp - unsharded plain|"
        f" / max |plain| = {err:.3e} (TP_TOL {TP_TOL:.0e}), finite "
        f"{finite}; K1 {c['K1']} K2 {c['K2']} (want 0: the kernels stay off"
        f" under tp) -> {'PASS' if enc_ok else 'FAIL'}")
    ok &= enc_ok

    dopts = dataclasses.replace(opts, sample_len=48)
    tables = build_rule_tables(cfg, dopts, qeng.tokenizer, device="cuda")
    prompts = [qeng.tokenizer.sot_sequence(language="en")]
    with MeshTap() as tap:
        t0 = time.perf_counter()
        got = decode_window_finalize(decode_window_dispatch(
            qeng.params, xa_tp, prompts, cfg, tables, dopts,
            compute_dtype=qeng.compute_dtype, mesh=tp2))
        dec_s = time.perf_counter() - t0
        with shard_context(ShardContext(None, plain=True)):
            want_res = decode_window_finalize(decode_window_dispatch(
                qeng.params, xa_tp, prompts, cfg, tables, dopts,
                compute_dtype=qeng.compute_dtype))
    same, first, gap, d = greedy_near_tie(
        [z[0] for z in tap.calls.get(threading.current_thread().name, [])],
        [z[0] for z in tap.calls.get("nwt-shard-0-0", [])],
        _emitted(want_res[0], eot, 48), _emitted(got[0], eot, 48))
    dec_ok = same or gap <= d
    log(f"[mesh] {card}: dp=1 x tp=2 decode, 48 steps: {len(got[0].tokens)}"
        f" tokens in {dec_s:.2f} s, against the unsharded plain decode: "
        + ("equal" if same else f"near-tie from token {first}: gap "
           f"{gap:.4f} {'<=' if dec_ok else '>'} D {d:.4f}")
        + f" (largest D {d:.4f}) -> {'PASS' if dec_ok else 'FAIL'}")
    ok &= dec_ok

    home = tempfile.mkdtemp(prefix="nwt-mesh-home-")
    try:
        ok &= serve_verb(card, home, extra=("--mesh", "1x1"), tag="mesh")
    finally:
        import shutil
        shutil.rmtree(home, ignore_errors=True)
    return ok, launches


# the tp window's encoder states against the unsharded plain path, relative
# to their largest magnitude: the tolerance for bf16 (at int8 the tp path is
# the same function bit for bit, tests/test_torch_parallel.py)
TP_TOL = 2e-2


def phase_native(card, qeng):
    """Native snapshots and the GGML writer on the card:

    * ``save_native`` then ``from_native`` of the int8 large-v3-turbo
      engine: the snapshot's size and the load time, every parameter equal
      bit for bit, and a 12 s transcription's tokens equal (ladder off);
    * ``params_to_ggml_tensors`` -> ``write_ggml`` -> ``from_ggml`` at
      turbo width (2 + 2 layers: the file is f32, 0.5 GB at this depth):
      every parameter back bit for bit;
    * ``resample_torch`` on the card against its CPU run (48 kHz and 44.1
      kHz to 16 kHz, 10 s): the same length and within 1e-5."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.audio.resample import resample_torch
    from nobs_whisper_torch.core import ggml
    from nobs_whisper_torch.core.native_ckpt import flatten
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models.whisper import (init_params,
                                                   params_to_ggml_tensors)
    from nobs_whisper_torch.audio.mel import mel_filter_bank
    from nobs_whisper_torch.utils.testing import speech_like_audio

    ok = True
    tmp = tempfile.mkdtemp(prefix="nwt-native-")
    try:
        snap = os.path.join(tmp, "snapshot")
        t0 = time.perf_counter()
        qeng.save_native(snap)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(snap, f))
                   for f in os.listdir(snap))
        t0 = time.perf_counter()
        back = WhisperEngine.from_native(snap, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a, b = flatten(qeng.params), flatten(back.params)
        same = (a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and b[k].is_cuda
            and torch.equal(a[k], b[k]) for k in a))
        opts = DecodeOptions(temperature_increment=0.0)
        audio = speech_like_audio(12.0, seed=81)
        r1 = qeng.transcribe(audio, language="en", opts=opts)
        r2 = back.transcribe(audio, language="en", opts=opts)
        toks = [s.tokens for s in r1.segments]
        tok_ok = toks == [s.tokens for s in r2.segments] and bool(toks)
        n_ok = same and tok_ok and back.compute_dtype == qeng.compute_dtype
        log(f"[native] {card}: int8 large-v3-turbo snapshot {size / 1e6:.1f}"
            f" MB ({len(b)} tensors) saved in {save_s:.2f} s, loaded to the"
            f" card in {load_s:.2f} s; parameters equal {same}, 12 s "
            f"transcription tokens ({sum(map(len, toks))}) equal {tok_ok} -> "
            f"{'PASS' if n_ok else 'FAIL'}")
        ok &= n_ok
        del back

        cfg = dataclasses.replace(qeng.cfg, n_audio_layer=2, n_text_layer=2)
        params = init_params(5, cfg, dtype=torch.bfloat16, device="cuda")
        path = os.path.join(tmp, "turbo-2-2.bin")
        t0 = time.perf_counter()
        ggml.write_ggml(path, cfg, mel_filter_bank(cfg.n_mels),
                        qeng.tokenizer._vocab,
                        params_to_ggml_tensors(params, cfg))
        g = WhisperEngine.from_ggml(path, dtype=torch.bfloat16,
                                    device="cuda")
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        a, b = flatten(params), flatten(g.params)
        g_ok = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
        log(f"[native] {card}: params_to_ggml_tensors -> write_ggml -> "
            f"from_ggml at turbo width, 2 + 2 layers, bf16 "
            f"({os.path.getsize(path) / 1e6:.1f} MB file, {g_s:.2f} s): "
            f"{len(a)} parameters equal {g_ok} -> "
            f"{'PASS' if g_ok else 'FAIL'}")
        ok &= g_ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for rate in (48000, 44100):
        x = torch.from_numpy(speech_like_audio(10.0, seed=82,
                                               sample_rate=rate))
        on_card = resample_torch(x.cuda(), rate)
        on_cpu = resample_torch(x, rate)
        diff = float((on_card.cpu() - on_cpu).abs().max())
        r_ok = (on_card.is_cuda and on_card.shape == on_cpu.shape
                and diff <= 1e-5)
        log(f"[native] {card}: resample_torch {rate} -> 16000 Hz, 10 s: "
            f"{on_card.shape[0]} samples on the card, max |card - CPU| "
            f"{diff:.3e} (tolerance 1e-5) -> {'PASS' if r_ok else 'FAIL'}")
        ok &= r_ok
    return ok, {}


# the [train] phase: f32 throughout (TF32 off); the card against the CPU,
# and the sharded paths against one device, are the same math in other
# f32 summation orders (cuBLAS against MKL, tp's partial sums, sp's
# shorter query blocks): the loss within 1e-5 relative, each gradient and
# encoder state within 1e-4 (gradients) and 1e-5 (states) of the
# reference's largest magnitude
TRAIN_LR = 1e-3
TRAIN_STEPS = 3
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_STATE_TOL = 1e-5


def _rel_max(got, want):
    """max |got - want| / max |want|, on the CPU in f32."""
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _cut_depth(params, n_enc, n_dec):
    """The first n_enc encoder and n_dec decoder layers of a tree."""
    out = {}
    for part, n in (("encoder", n_enc), ("decoder", n_dec)):
        out[part] = dict(params[part])
        out[part]["blocks"] = {k: v[:n] for k, v in
                               params[part]["blocks"].items()}
    return out


def _train_step_flop(cfg, b, s):
    """Operations (two a multiply-add) of one train step's matrix products
    and convolutions: the forward's, times 3 (the backward takes two
    products for each of the forward's, wrt the input and wrt the weight).
    A window of T = n_audio_ctx encoder rows of width d: the stem's two
    convolutions (2T x 3 n_mels x d, T x 3d x d), then per encoder layer
    24 T d^2 (q, k, v, o and the 4d-wide MLP) and 4 T^2 d (scores and
    their product with v). The decoder's S = s - 1 positions of width d_t:
    per layer 28 S d_t^2 (self q/k/v/o, cross q/o, MLP), 4 S^2 d_t (self
    attention), 4 T d_t^2 (cross k, v over the encoder's rows) and
    4 S T d_t (cross attention), then the 2 S d_t V logits."""
    t, d, m = cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_mels
    dt, n = cfg.n_text_state, s - 1
    enc = (2 * 2 * t * 3 * m * d + 2 * t * 3 * d * d
           + cfg.n_audio_layer * (24 * t * d * d + 4 * t * t * d))
    dec = (cfg.n_text_layer * (28 * n * dt * dt + 4 * n * n * dt
                               + 4 * t * dt * dt + 4 * n * t * dt)
           + 2 * n * dt * cfg.n_vocab)
    return 3 * b * (enc + dec)


def _train_batch(cfg, dev, b=2, s=32, pad=4):
    """``b`` windows of speech-like audio, their mel by K14
    (``log_mel_spectrogram_pallas``; no gradient needed, so under
    ``no_grad``: an inference tensor could not be saved for the conv's
    backward), ``s`` tokens a row from a seeded generator, and a mask of
    ones but the last ``pad`` positions of the last row."""
    import numpy as np
    import torch
    from nobs_whisper_torch.audio.mel import pad_or_trim
    from nobs_whisper_torch.ops import mel_pallas as mp
    from nobs_whisper_torch.utils.testing import speech_like_audio
    audio = torch.from_numpy(np.stack([
        np.asarray(pad_or_trim(torch.from_numpy(
            speech_like_audio(d, seed=90 + i))))
        for i, d in enumerate((12.0, 25.0, 7.0, 18.0)[:b])])).to(dev)
    with torch.no_grad():
        mel = mp.log_mel_spectrogram_pallas(audio, cfg.n_mels)
    g = torch.Generator().manual_seed(91)
    tokens = torch.randint(0, cfg.eot, (b, s), generator=g).to(dev)
    mask = torch.ones((b, s), dtype=torch.float32)
    mask[-1, s - pad:] = 0
    return mel, tokens, mask.to(dev)


def phase_train(card, eng, dev="cuda"):
    """Training on the card (``models/training.py``), pp and sp, at the
    width of large-v3-turbo (random weights from seed 0: ``eng``'s, as a
    trainable f32 tree), f32 compute, TF32 off:

    * the batch: two windows' mel by K14 (one launch), 32 tokens a row,
      four padded positions;
    * full depth (32 + 4 layers) on ``cuda:0``: three ``train_step``s at
      lr 1e-3, each timed after a sync, the peak memory; the loss finite
      and falling; no kernel launched (training runs the plain ops);
    * 2 + 2 layers: the same step on the card and on the CPU, the losses
      within ``TRAIN_LOSS_TOL`` and the gradients of ``conv1_w``, the
      second encoder block's ``fc1_w`` and the decoder's ``tok_emb``
      within ``TRAIN_GRAD_TOL``;
    * the guard: the bf16 loss at 2 + 2 layers with the plain-ops context
      taken away reaches K3 with trainable inputs and raises, and K3
      counts no launch;
    * sharded, 2 + 2 layers, on two cards or on ``cuda:0`` twice: a dp=1 x
      tp=2 ``train_step`` (loss and every master gradient against the
      one-device step), ``encode_pipelined`` on pp=2 with two microbatches
      and ``encode_seq_parallel`` on sp=2 against the one-device plain
      encode (``TRAIN_STATE_TOL``), and the gradient wrt the mel through
      the pp schedule;
    * back to serving: the trained full-depth weights, rounded to bf16
      and quantized into a ``WhisperEngine``, transcribe a 12 s clip:
      K1 = K2 = 32, no other kernel.

    ``dev`` "cpu" rehearses the phase's flow on a tiny engine (the counts
    stay 0 there: only a launch on the card counts)."""
    import contextlib
    import dataclasses
    import math

    import torch
    from nobs_whisper_torch.core.native_ckpt import flatten
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models import training as tr
    from nobs_whisper_torch.models.whisper import _encode
    from nobs_whisper_torch.parallel.mesh import make_mesh
    from nobs_whisper_torch.parallel.pipeline import (encode_pipelined,
                                                      make_pp_mesh)
    from nobs_whisper_torch.parallel.seqparallel import (encode_seq_parallel,
                                                         make_sp_mesh)
    from nobs_whisper_torch.parallel.tp import plain_ops
    from nobs_whisper_torch.utils.testing import speech_like_audio

    cfg = eng.cfg
    f32 = torch.float32
    ok = True
    launches = {}

    reset_counts()
    mel, tokens, mask = _train_batch(cfg, dev)
    torch.cuda.synchronize()
    c = read_counts()
    b_ok = (only(c, {"K14": 1}) and tuple(mel.shape) == (
        2, cfg.n_mels, 2 * cfg.n_audio_ctx) and not mel.is_inference()
        and bool(torch.isfinite(mel).all()))
    log(f"[train] {card}: batch of 2 windows (12 s, 25 s) by "
        f"log_mel_spectrogram_pallas {tuple(mel.shape)}, tokens "
        f"{tuple(tokens.shape)}, mask sum {int(mask.sum())}: launches "
        f"{_launch_summary(c)} (want K14 = 1) -> "
        f"{'PASS' if b_ok else 'FAIL'}")
    ok &= b_ok
    launches["K14"] = c["K14"]

    # full depth, one card
    master = tr.trainable_params(eng.params, device=dev, dtype=f32)
    n_params = sum(t.numel() for t in flatten(master).values())
    opt = tr.make_optimizer(master, lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, times = [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = tr.train_step(master, opt, mel, tokens, mask, cfg, f32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    c = read_counts()
    peak = torch.cuda.max_memory_allocated()
    f_ok = (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and only(c, {}))
    log(f"[train] {card}: full depth ({cfg.n_audio_layer} + "
        f"{cfg.n_text_layer} layers, {n_params / 1e6:.1f} M parameters, "
        f"f32 master on {dev}, AdamW lr {TRAIN_LR}): losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}; step times "
        f"{', '.join(f'{t:.3f}' for t in times)} s; peak memory "
        f"{peak / 2**30:.2f} GiB (of it {base / 2**30:.2f} GiB allocated "
        f"before the steps); launches {_launch_summary(c)} (want none) -> "
        f"{'PASS' if f_ok else 'FAIL'}")
    ok &= f_ok
    flop = _train_step_flop(cfg, *tokens.shape)
    steady = min(times[1:])
    log(f"[train] {card}: one step's matrix products {flop / 1e12:.3f} "
        f"TFLOP (_train_step_flop), over the fastest later step "
        f"{steady:.3f} s: {flop / steady / 1e12:.2f} TFLOP/s (host-timed "
        f"after a sync; f32 without TF32)")

    # back to serving: the trained weights through the int8 engine
    with torch.no_grad():
        served = {part: {k: ({kk: vv.detach().to(torch.bfloat16)
                              for kk, vv in v.items()}
                             if isinstance(v, dict)
                             else v.detach().to(torch.bfloat16))
                         for k, v in master[part].items()}
                  for part in master}
    moved = _rel_max(served["encoder"]["blocks"]["fc1_w"],
                     eng.params["encoder"]["blocks"]["fc1_w"].float())
    del master, opt, loss
    torch.cuda.empty_cache()
    trained = dataclasses.replace(eng, params=served).quantize()
    reset_counts()
    t0 = time.perf_counter()
    r = trained.transcribe(speech_like_audio(12.0, seed=92), language="en",
                           opts=DecodeOptions(temperature_increment=0.0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = read_counts()
    n_tok = sum(len(s.tokens) for s in r.segments)
    s_ok = (only(c, {"K1": cfg.n_audio_layer, "K2": cfg.n_audio_layer})
            and c["batches"] == 1 and isinstance(r.text, str) and all(
                math.isfinite(s.avg_logprob) for s in r.segments))
    log(f"[train] {card}: the trained weights (fc1_w moved by "
        f"{moved:.3e} of its largest magnitude), bf16, quantized into a "
        f"WhisperEngine: 12 s transcription in {dt:.2f} s, {n_tok} tokens; "
        f"launches {_launch_summary(c)} (want K1 = K2 = "
        f"{cfg.n_audio_layer}) -> {'PASS' if s_ok else 'FAIL'}")
    ok &= s_ok
    launches["K1"], launches["K2"] = c["K1"], c["K2"]
    del trained, served, r
    torch.cuda.empty_cache()

    # 2 + 2 layers: the card against the CPU
    small_cfg = dataclasses.replace(cfg, n_audio_layer=2, n_text_layer=2)
    small = _cut_depth(eng.params, 2, 2)
    on_card = tr.trainable_params(small, device=dev, dtype=f32)
    on_cpu = tr.trainable_params(small, device="cpu", dtype=f32)
    t0 = time.perf_counter()
    l_card = tr.loss_fn(on_card, mel, tokens, mask, small_cfg, f32)
    l_card.backward()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_cpu = tr.loss_fn(on_cpu, mel.cpu(), tokens.cpu(), mask.cpu(),
                       small_cfg, f32)
    l_cpu.backward()
    cpu_s = time.perf_counter() - t0
    l_err = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    picks = {"conv1_w": lambda p: p["encoder"]["conv1_w"],
             "blocks.fc1_w[1]": lambda p: p["encoder"]["blocks"]["fc1_w"],
             "tok_emb": lambda p: p["decoder"]["tok_emb"]}
    g_err = {}
    for name, pick in picks.items():
        a, b = pick(on_card).grad, pick(on_cpu).grad
        if name.endswith("[1]"):
            a, b = a[1], b[1]
        g_err[name] = _rel_max(a, b)
    c_ok = l_err <= TRAIN_LOSS_TOL and all(
        e <= TRAIN_GRAD_TOL for e in g_err.values())
    log(f"[train] {card}: 2 + 2 layers, one step's loss and gradients on "
        f"the card ({card_s:.2f} s) against the CPU ({cpu_s:.2f} s): loss "
        f"{l_card.item():.6f} / {l_cpu.item():.6f}, relative {l_err:.3e} "
        f"(<= {TRAIN_LOSS_TOL:.0e}); gradients, max |card - CPU| / max "
        f"|CPU|: " + ", ".join(f"{k} {v:.3e}" for k, v in g_err.items())
        + f" (<= {TRAIN_GRAD_TOL:.0e}) -> {'PASS' if c_ok else 'FAIL'}")
    ok &= c_ok
    del on_cpu, l_cpu

    # the guard: no kernel inside a training forward
    guard = tr.trainable_params(small, device=dev)   # bf16, as served
    real = tr._tp.plain_ops
    tr._tp.plain_ops = contextlib.nullcontext
    reset_counts()
    raised = ""
    try:
        tr.loss_fn(guard, mel, tokens, mask, small_cfg, torch.bfloat16)
    except RuntimeError as e:
        raised = str(e)
    finally:
        tr._tp.plain_ops = real
    c = read_counts()
    g_ok = raised.startswith("K3: a hand-written kernel") and only(c, {})
    log(f"[train] {card}: the bf16 loss at 2 + 2 layers without the "
        f"plain-ops context: {'raised ' + repr(raised[:60]) if raised else 'no error'}"
        f" (want K3's guard), launches {_launch_summary(c)} (want none) "
        f"-> {'PASS' if g_ok else 'FAIL'}")
    ok &= g_ok
    del guard

    # sharded, 2 + 2 layers
    n_cards = torch.cuda.device_count()
    pair = (["cuda:0", "cuda:1"] if n_cards >= 2 else ["cuda:0", "cuda:0"])
    where = ("two cards, cuda:0 and cuda:1" if n_cards >= 2
             else "one card, cuda:0 twice")
    if dev == "cpu":
        pair, where = ["cpu", "cpu"], "the CPU twice"
    one = tr.trainable_params(small, device=dev, dtype=f32)
    sh = tr.trainable_params(small, device=dev, dtype=f32)
    t0 = time.perf_counter()
    l_one = tr.train_step(one, tr.make_optimizer(one, lr=TRAIN_LR), mel,
                          tokens, mask, small_cfg, f32)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_tp = tr.train_step(sh, tr.make_optimizer(sh, lr=TRAIN_LR), mel,
                         tokens, mask, small_cfg, f32,
                         mesh=make_mesh(dp=1, tp=2, devices=pair))
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t0
    lt_err = abs(l_tp.item() - l_one.item()) / abs(l_one.item())
    worst, worst_name = 0.0, ""
    ref_leaves = flatten(one)
    for name, t in flatten(sh).items():
        e = _rel_max(t.grad, ref_leaves[name].grad)
        if e >= worst:
            worst, worst_name = e, name
    t_ok = lt_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL
    log(f"[train] {card}: dp=1 x tp=2 train step on {where} ({tp_s:.2f} s;"
        f" one device {one_s:.2f} s): loss {l_tp.item():.6f} against "
        f"{l_one.item():.6f}, relative {lt_err:.3e} (<= "
        f"{TRAIN_LOSS_TOL:.0e}); master gradients, largest max |tp - one| "
        f"/ max |one| {worst:.3e} ({worst_name}; <= {TRAIN_GRAD_TOL:.0e})"
        f" -> {'PASS' if t_ok else 'FAIL'}")
    ok &= t_ok
    del sh

    with torch.no_grad(), plain_ops():
        ref = _encode(one, mel, small_cfg, f32)
        t0 = time.perf_counter()
        pp = encode_pipelined(one, mel, small_cfg,
                              make_pp_mesh(pp=2, devices=pair), n_micro=2)
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sp = encode_seq_parallel(one, mel, small_cfg,
                                 make_sp_mesh(2, devices=pair))
        torch.cuda.synchronize()
        sp_s = time.perf_counter() - t0
    pp_err, sp_err = _rel_max(pp, ref), _rel_max(sp, ref)
    e_ok = (pp.shape == ref.shape == sp.shape and pp_err <= TRAIN_STATE_TOL
            and sp_err <= TRAIN_STATE_TOL)
    log(f"[train] {card}: 2 layers on {where}: encode_pipelined pp=2, "
        f"n_micro=2 ({pp_s:.2f} s) and encode_seq_parallel sp=2 "
        f"({sp_s:.2f} s) against the one-device plain encode: max |got - "
        f"one| / max |one| {pp_err:.3e} and {sp_err:.3e} (<= "
        f"{TRAIN_STATE_TOL:.0e}) -> {'PASS' if e_ok else 'FAIL'}")
    ok &= e_ok

    x_pp = mel.clone().requires_grad_(True)
    (encode_pipelined(one, x_pp, small_cfg, make_pp_mesh(pp=2, devices=pair),
                      n_micro=2) ** 2).sum().backward()
    x_one = mel.clone().requires_grad_(True)
    with plain_ops():
        (_encode(one, x_one, small_cfg, f32) ** 2).sum().backward()
    gi_err = _rel_max(x_pp.grad, x_one.grad)
    gi_ok = gi_err <= TRAIN_GRAD_TOL and float(x_one.grad.abs().max()) > 0
    log(f"[train] {card}: gradient wrt the mel through the pp=2 schedule on "
        f"{where}: max |pp - one| / max |one| {gi_err:.3e} (<= "
        f"{TRAIN_GRAD_TOL:.0e}) -> {'PASS' if gi_ok else 'FAIL'}")
    ok &= gi_ok
    del one, on_card, x_pp, x_one, mel
    torch.cuda.empty_cache()
    return ok, launches



# the speech LM's configuration at its published widths (the benchmark's
# configuration file, read as data)
UNIMOE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "benchmark", "configs",
                             "uni-moe-2.0-omni-audio.json")
# the expert kernels against their plain version: both sum bf16 products
# in f32 and round h to bf16 at the same point; the order of the f32 sums
# differs (~1e-6 of a sum), which flips a few elements of a row's h by one
# bf16 step (2^-8 of it). A flip moves an output by 2^-8 |h w|, up to ~1e-3
# of the outputs' scale where h is among the largest of a prefill's 2e8
# (measured on an H100: 0.67e-3 at 32 tokens, 0.97e-3 and 1.04e-3 at
# 11,136). 4e-3 leaves that fourfold room and fails a tile whose rows,
# columns or expert are wrong, which is off by the scale itself.
MOE_TOL = 4e-3
UNIMOE_ROWS = 8          # the serving wave's requests, one batch


def moe_least_ms(d, f, n_shared, f_shared, tokens, rows):
    """One layer's experts at the published peaks: operations (6 d width a
    row of an expert) against bytes (each expert hit's weights once, the
    rows' activations in and out), as ``benchmark/ops/moe_arith.py``
    counts them."""
    ops = 6.0 * d * (f * sum(rows) + f_shared * n_shared * tokens)
    hit = sum(1 for r in rows if r > 0)
    nbytes = 3 * d * 2 * (f * hit + f_shared * n_shared) \
        + 2 * d * 2 * (sum(rows) + n_shared * tokens)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def moe_kernel_check(p, cfg, tokens, seed):
    """``ops/moe.py::expert_ffn`` on one layer's routed and shared
    experts (``p``) at ``tokens`` random rows routed by the layer's own
    gate, against ``expert_ffn_plain``: (max error over the outputs'
    scale, ms of both calls alone in a CUDA graph, bound ms, plain ms,
    routed rows by expert)."""
    import torch
    from nobs_whisper_torch.ops import moe
    dev = p["w13"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((tokens, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    ids, w = moe.route(x, p["gate"], cfg.top_p, cfg.top_k, cfg.n_routed)
    sid = torch.arange(cfg.n_shared, device=dev).expand(tokens, cfg.n_shared)
    sw = torch.ones((tokens, cfg.n_shared), device=dev)
    err = 0.0
    for i, w13, w2, i_, w_ in ((0, p["w13"], p["w2"], ids, w),
                               (1, p["s13"], p["s2"], sid, sw)):
        got = moe.expert_ffn(x, i_, w_, w13, w2)
        pl = moe.plan(i_, w2.shape[0], moe.BM)
        want = moe.expert_ffn_plain(x, pl, w_, w13, w2, cfg.top_k).view(
            tokens, -1, cfg.d_model).sum(1)
        scale = want.abs().max().item()
        err = max(err, (got - want).abs().max().item() / scale)
    rows = torch.bincount(ids[(ids >= 0) & (ids < cfg.n_routed)],
                          minlength=cfg.n_routed).tolist()
    both = lambda: (moe.expert_ffn(x, ids, w, p["w13"], p["w2"]),
                    moe.expert_ffn(x, sid, sw, p["s13"], p["s2"]))
    pl = moe.plan(ids, cfg.n_routed, moe.BM)
    spl = moe.plan(sid, cfg.n_shared, moe.BM)
    plain = lambda: (
        moe.expert_ffn_plain(x, pl, w, p["w13"], p["w2"], cfg.top_k),
        moe.expert_ffn_plain(x, spl, sw, p["s13"], p["s2"], cfg.n_shared))
    bound = moe_least_ms(cfg.d_model, cfg.expert_width, cfg.n_shared,
                         cfg.shared_width, tokens, rows)
    return (err, graph_ms(both, reps=10), bound,
            cuda_ms(plain, reps=2, warmup=1), rows)


def phase_uni_moe(card):
    """The speech LM (``models/uni_moe.py``) at the published widths of
    Uni-MoE-2.0-Omni's audio-to-text path (``benchmark/configs/
    uni-moe-2.0-omni-audio.json``: 28 layers, d 3584, 4 routed experts of
    18,944, a null, 2 shared of 2,368), random weights made on the card,
    the tower int8 and the language model bf16: a wave of
    ``UNIMOE_ROWS`` concurrent requests through ``BatchedEngine.
    transcribe`` (fixed language, the ladder off), whose ``moe_`` kernel
    launches, reset just before and read just after, must be 4 a layer a
    forward (routed and shared, two kernels each) over the batches'
    forwards (the prefill's, each decode step's with the graph's replays,
    and the warm-up step before a batch size's first capture) and whose
    every request must leave its routing on the tracer; then ``expert_ffn`` against ``expert_ffn_plain`` on layer 0's
    experts at a decode batch (32 tokens) and at the ``unimoe-chunks``
    cell's prefill (11,136 tokens) within ``MOE_TOL`` of the outputs'
    scale, timed alone in a CUDA graph against their least time and the
    plain version's. Returns (ok, {"MoE": launches}, the kernel's
    entry)."""
    import torch
    from nobs_whisper_torch.api import UniMoEEngine
    from nobs_whisper_torch.core.config import uni_moe_config_from_hparams
    from nobs_whisper_torch.core.tokenizer import UniMoETokenizer
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.models import uni_moe
    from nobs_whisper_torch.ops import moe
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    from nobs_whisper_torch.utils.testing import speech_like_audio

    with open(UNIMOE_CONFIG) as f:
        cfg = uni_moe_config_from_hparams(json.load(f))
    t0 = time.perf_counter()
    eng = UniMoEEngine(
        params=uni_moe.init_params(0, cfg, dtype=torch.bfloat16,
                                   device="cuda"),
        cfg=cfg, tokenizer=UniMoETokenizer([bytes([i]) for i in range(256)]
                                           + [b"w%d" % i for i in range(
                                               256, cfg.endoftext)], cfg),
        compute_dtype=torch.bfloat16, device=torch.device("cuda")).quantize()
    torch.cuda.synchronize()
    log(f"[uni-moe] {cfg.name}: {cfg.n_layer} layers, d {cfg.d_model}, "
        f"{cfg.n_routed} routed experts of {cfg.expert_width}, "
        f"{cfg.n_shared} shared of {cfg.shared_width}, random weights from "
        f"seed 0: built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    be = BatchedEngine(eng, opts=DecodeOptions(
        language="en", temperature_increment=0.0, sample_len=32),
        max_batch=UNIMOE_ROWS, max_wait_ms=500.0)
    try:
        # the records are kept in bounded queues: this wave's by their
        # stamps and by the wave's prompts
        t_ns = time.time_ns()
        warm = len(uni_moe._WARMED)
        moe.moe_launch_count = 0
        t0 = time.perf_counter()
        futs, results = [], []
        with concurrent.futures.ThreadPoolExecutor(UNIMOE_ROWS) as pool:
            for i in range(UNIMOE_ROWS):
                futs.append(pool.submit(
                    be.transcribe, speech_like_audio(6.0 + 2 * i, seed=70 + i),
                    language="en", context=f"chunk {i} of the smoke wave"))
            results = [f.result() for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = moe.moe_launch_count
        recs = [r for r in GLOBAL_PROFILER.batch_records()
                if r.start_ns >= t_ns]
        # the prefill's and each step's, and one eager step's before the
        # first capture at a batch size (models/uni_moe.py::window_impl)
        warm = len(uni_moe._WARMED) - warm
        forwards = sum(1 + r.calls["forward"] for r in recs) + warm
        want = 4 * cfg.n_layer * forwards
        kept = sum(1 for pr, _, _ in GLOBAL_PROFILER.routing_records()
                   if "of the smoke wave" in eng.tokenizer.decode(list(pr)))
        ok = (launches == want and kept == UNIMOE_ROWS
              and all(r.text is not None for r in results))
        log(f"[uni-moe] {card}: wave of {UNIMOE_ROWS} through "
            f"BatchedEngine.transcribe in {wall:.2f} s; batch sizes "
            f"{be.batcher.batch_sizes}; forwards {forwards} (replays "
            f"{sum(r.replays for r in recs)}, warm-up {warm}); moe_ "
            f"launches {launches} "
            f"(want 4 x {cfg.n_layer} x {forwards} = {want}); routing kept "
            f"{kept} -> {'PASS' if ok else 'FAIL'}")
    finally:
        be.close()
    p = eng.params["layers"][0]
    entry = None
    for name, tokens in (("decode", 32), ("prefill", 11136)):
        err, ms, bound, plain_ms, rows = moe_kernel_check(p, cfg, tokens,
                                                          tokens)
        good = err <= MOE_TOL
        ok &= good
        log(f"[uni-moe] expert_ffn {name} {tokens} tokens (routed rows "
            f"{rows}): max err {err:.2e} of the scale (tol {MOE_TOL}); "
            f"{ms:.4f} ms alone, bound {bound:.4f} ms, plain "
            f"{plain_ms:.4f} ms -> {'PASS' if good else 'FAIL'}")
        if entry is None:
            entry = dict(name="MoE", route="cuda",
                         source="nobs_whisper_torch/csrc/moe.cu",
                         replaces="none", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes", library_ms=None, ok=good)
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["ok"] &= good
            entry["prefill"] = dict(ms=ms, bound_ms=bound,
                                    plain_ms=plain_ms)
    del eng, p
    torch.cuda.empty_cache()
    return ok, {"MoE": launches}, entry


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from nobs_whisper_torch.core.device import disable_tf32
    disable_tf32()
    t_start = time.perf_counter()
    marks = [t_start]

    def took(name):
        marks.append(time.perf_counter())
        log(f"[time] {name}: {marks[-1] - marks[-2]:.1f} s")

    smi = phase_card_and_build()
    card = smi
    took("card and build")
    if sys.argv[1:] == ["uni_moe"]:      # phases 1 and 18 alone
        ok, counts, entry = phase_uni_moe(card)
        took("uni-moe")
        entry = dict(entry, launches=counts["MoE"])
        ok &= entry.pop("ok") and entry["launches"] > 0
        log(f"[done] {card}: total {time.perf_counter() - t_start:.1f} s, "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            return 1
        print(smi)
        print(json.dumps({"kernels": [entry]}))
        return 0
    ok, launches = True, {}
    kern = phase_kernels()
    took("kernels")
    ok &= phase_reference()
    took("reference")
    from nobs_whisper_torch.api import WhisperEngine
    eng = WhisperEngine.from_random("large-v3-turbo", seed=0, device="cuda")
    torch.cuda.synchronize()
    cfg = eng.cfg
    log(f"[engine] large-v3-turbo d={cfg.n_audio_state} enc_layers="
        f"{cfg.n_audio_layer} dec_layers={cfg.n_text_layer} heads "
        f"{cfg.n_audio_head}, random weights from seed 0, bf16: built "
        f"in {time.perf_counter() - marks[-1]:.1f} s")
    t0 = time.perf_counter()
    qeng = eng.quantize()
    torch.cuda.synchronize()
    log(f"[serve] engine large-v3-turbo int8 encoder and decoder, bf16 "
        f"compute, seed 0: quantized in {time.perf_counter() - t0:.1f} s")
    took("engines")
    for name, phase, args in (
            ("serving", phase_serving, (card, qeng)),
            ("transcribe", phase_transcribe, (card, eng)),
            ("decode kernels", phase_decode_kernels, (card, qeng, eng)),
            ("encoder knobs", phase_encoder_knobs, (card, qeng, eng)),
            ("attention variants", phase_attention_variants,
             (card, qeng, eng))):
        phase_ok, counts = phase(*args)
        ok &= phase_ok
        for key, n in counts.items():     # K9 runs on two phases' paths
            launches[key] = launches.get(key, 0) + n
        took(name)
    phase_ok, counts = phase_ops(card, qeng)
    ok &= phase_ok
    launches.update(counts)
    took("ops")
    for name, phase, args in (("server", phase_server, (card, qeng)),
                              ("beam", phase_beam, (card, qeng, eng))):
        phase_ok, counts = phase(*args)
        ok &= phase_ok
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        took(name)
    ok &= phase_router(card)
    took("router")
    for name, phase in (("speculative", phase_speculative),
                        ("words", phase_words)):
        phase_ok, counts = phase(card, qeng, eng)
        ok &= phase_ok
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        took(name)
    for name, phase, args in (("mesh", phase_mesh, (card, qeng)),
                              ("native", phase_native, (card, qeng)),
                              ("train", phase_train, (card, eng))):
        phase_ok, counts = phase(*args)
        ok &= phase_ok
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        took(name)
    phase_ok, counts, moe_entry = phase_uni_moe(card)
    ok &= phase_ok
    launches.update(counts)
    kern["MoE"] = moe_entry
    took("uni-moe")
    entries = []
    for key, e in kern.items():
        e = dict(e)
        ok &= e.pop("ok")
        e["launches"] = launches.get(key, 0)
        ok &= e["launches"] > 0
        entries.append(e)
    log(f"[done] {card}: total {time.perf_counter() - t_start:.1f} s, "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        return 1
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
