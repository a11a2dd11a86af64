"""What the CPU can check of K4's plan on Hopper: the Python mirror of how
``csrc/cross_attention_decode.cu`` cuts the bf16 cross-attention decode
step, tied to the source's constants and rules.

K4 runs a thread-block cluster of C blocks per (batch row, head), each
block a slice of the encoder positions that streams through a ring of
shared memory (K, R rows of the slice a stage, then V, boxes of rows).
``ops/attention_pallas.py::k4_plan`` is the kernel's choice of C and of
the slice, ``k4_rows`` and ``k4_vbox`` what a stage holds and ``k4_smem``
a block's shared memory: every position falls in exactly one slice and
one V box, a slice's K rows fill whole stages, slices are multiples of 8
positions, and at large-v3-turbo the grid is one wave at B = 1, 8 and 16
(the on-card counts the plan was measured against: five blocks an SM,
154 clusters of 4 at once; ``scripts/torch_xattn_variants.py --kernel K4
--trace``).

The kernel itself runs on the card (``tests/test_torch_kernels_gpu.py``).
"""

import os
import re

import numpy as np
import pytest

from nobs_whisper_torch.ops import attention_pallas as ap

CSRC = os.path.join(os.path.dirname(ap.__file__), os.pardir, "csrc")
SMS = 132                 # an H100 SXM's multiprocessors
SM_SMEM = 233472          # shared memory an SM holds (228 KB)
BLOCK_RESERVED = 1024     # what the card keeps of it for each block


def _source():
    with open(os.path.join(CSRC, "cross_attention_decode.cu")) as f:
        return f.read()


def _constant(src, name):
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


# the most K4 blocks (Dh 64) an H100 holds at once, one an SM
# (cudaOccupancyMaxActiveClusters at C = 1: 660 = 5 x 132; at C = 4, 154
# clusters), and what the launch bounds leave registers for
RESIDENT = 5


def _resident(dh, s):
    """K4 blocks an SM holds: by shared memory, threads (2048 an SM; the
    compute threads and one copying warp a block) and the card's measured
    limit."""
    return min(SM_SMEM // (ap.k4_smem(dh, s) + BLOCK_RESERVED),
               2048 // (ap.K4_THREADS + 32), RESIDENT)


def test_k4_constants_match_the_kernel():
    """The Python plan's constants are the kernel's, and the checkout
    builds the plan's own cluster size, not an ablation's fixed one."""
    src = _source()
    names = ("K4_THREADS", "K4_MAX_C", "K4_STEP", "K4_SPAN", "K4_MIN_SLICE",
             "K4_STAGE", "K4_STAGES", "K4_TARGET", "K4_SMEM_MAX")
    assert {n: _constant(src, n) for n in names} == {
        n: getattr(ap, n) for n in names}
    assert _constant(src, "K4_FORCE_C") == 0
    assert "constexpr int K4_PK = 4 * K4_THREADS;" in src
    assert ap.K4_PK == 4 * ap.K4_THREADS
    # a slice's words over the threads: two registers' worth each
    assert "constexpr int K4_WORDS = K4_SPAN / (4 * K4_THREADS);" in src
    assert ap.K4_SPAN // (4 * ap.K4_THREADS) == 2
    assert f"__launch_bounds__(K4_THREADS + 32, {RESIDENT})" in src
    assert "K4_THREADS + 32, k4_smem(DH, args.S), st, args);" in " ".join(
        src.split())


def test_k4_rule_and_shared_memory_match_the_kernel():
    """``k4_plan``'s loop, ``k4_rows``, ``k4_vbox`` and ``k4_smem`` are the
    rules the kernel's host code and shared-memory layout use."""
    src = " ".join(_source().split())
    for rule in (
            "int r = 1; while (2 * r <= dh && 2 * r * 2 * s <= K4_STAGE) "
            "r *= 2; return r;",
            "return K4_STAGE / (2 * dh);",
            "return 8 * (2 * K4_STAGES + 4) + 4 * K4_PK + 4 * dh + 4 * 2 * "
            "K4_MAX_C + 4 * dh + 4 * K4_WARPS;",
            "return (k4_head(dh) + 127) & ~127;",
            "return (size_t)k4_head_aligned(dh) + (size_t)K4_STAGES * "
            "K4_STAGE + (size_t)4 * s;",
            "auto slice = [&](int c) { return (chunks + c - 1) / c * "
            "K4_STEP; };",
            "while (c < K4_MAX_C && 2 * c <= chunks && (slice(c) > K4_SPAN || "
            "((long long)c * bh < (long long)K4_TARGET * sms && slice(2 * c) "
            ">= K4_MIN_SLICE))) c *= 2;",
            "return S <= K4_SPAN ? c : 0;",
            "const int c = k4_plan(BH, a.Tp, sm_count(), args.S);",

            "const int R = k4_rows(S, DH), nk = n > 0 ? DH / R : 0;",
            "const int bv = k4_vbox(DH), nv = (n + bv - 1) / bv;"):
        assert rule in src, rule
    assert ap.k4_smem(64, 192) == 2816 + 3 * 8192 + 4 * 192


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("tp", [128, 384, 1536])
@pytest.mark.parametrize("b", [1, 8, 16])
def test_k4_plan_covers_every_position_once(b, tp, dh):
    """Every position of Tp lies in exactly one block's slice and, within
    it, in one V box; slices are multiples of 8 and at most ``K4_SPAN``; a
    stage holds R rows of a slice (a power of two that divides Dh, so the
    Dh rows fill whole stages) or a V box; C is a power of two up to 16
    and at most half the 8-position chunks, and stops doubling only once
    the grid has ``K4_TARGET`` blocks an SM, or a halving would cut the
    slice under ``K4_MIN_SLICE`` (or at its limits); a block's shared
    memory leaves room for five blocks an SM."""
    bh = 20 * b
    c, s = ap.k4_plan(bh, tp, SMS)
    assert c in (1, 2, 4, 8, 16) and c <= max(1, tp // 16)
    assert s % ap.K4_STEP == 0 and 0 < s <= ap.K4_SPAN
    r, bv = ap.k4_rows(s, dh), ap.k4_vbox(dh)
    assert dh % r == 0 and 2 * r * s <= ap.K4_STAGE
    assert bv % ap.K4_STEP == 0 and 2 * dh * bv == ap.K4_STAGE
    covered = np.concatenate([
        np.arange(r0 + i, min(tp, r0 + min(s, i + bv)))
        for r0 in range(0, c * s, s) for i in range(0, s, bv)])
    assert np.array_equal(covered, np.arange(tp))
    assert _resident(dh, s) == RESIDENT
    if not (c == ap.K4_MAX_C or 2 * c > tp // ap.K4_STEP):
        halved = -(-(tp // ap.K4_STEP) // (2 * c)) * ap.K4_STEP
        assert c * bh >= ap.K4_TARGET * SMS or halved < ap.K4_MIN_SLICE


def test_k4_plan_at_turbo_is_one_wave():
    """large-v3-turbo (20 heads of 64, Tp 1536): B = 1 takes a cluster of 8
    (160 blocks of 192 positions: two stages of 16 rows of K and three V
    boxes of 64, the ring's three stages filled at entry); B = 8 and 16 a
    cluster of 2 (320 and 640 blocks of 768 positions: 16 stages of 4 rows
    of K, 12 V boxes). Five blocks share an SM, so each grid is one wave
    on 132 SMs: at B = 16 4-5 blocks an SM (C = 1 would put 2 or 3, the
    SMs with 3 holding 1.24x the mean bytes); clusters of 4 at B = 8 need
    160 of the 154 the card holds."""
    assert ap.k4_plan(20, 1536, SMS) == (8, 192)
    assert (ap.k4_rows(192, 64), ap.k4_vbox(64)) == (16, 64)
    assert ap.k4_plan(160, 1536, SMS) == (2, 768)
    assert ap.k4_plan(320, 1536, SMS) == (2, 768)
    assert ap.k4_rows(768, 64) == 4
    for b in (1, 8, 16):
        c, s = ap.k4_plan(20 * b, 1536, SMS)
        assert c * 20 * b <= _resident(64, s) * SMS
    # the most (batch row, head) pairs' bytes one SM holds at B = 16
    share = lambda c: -(-(c * 320) // SMS) / c
    assert share(2) == 2.5 < share(1) == 3
    c5, s5 = ap.k5_plan(320, 1536, SMS)
    k5_resident = SM_SMEM // (ap.k5_smem(64, s5) + BLOCK_RESERVED)
    assert (c5, k5_resident) == (2, 3) and c5 * 320 > k5_resident * SMS


def test_k4_plan_at_the_edge_cases():
    """The on-card edge cases' slices: Tp = 384 at 8 (batch row, head)
    pairs takes C = 2, slices of 192, so t_real = 40 and 10 lie inside the
    first slice and leave the second empty; Tp = 1000 at 8 pairs takes
    C = 4, slices of 256, the last short (232), and t_real = 700 ends in
    the third and leaves the last empty; Tp = 8 is one chunk (C = 1)."""
    assert ap.k4_plan(8, 384, SMS) == (2, 192)
    c, s = ap.k4_plan(8, 1000, SMS)
    assert (c, s) == (4, 256)
    assert [min(s, max(0, 1000 - r * s)) for r in range(c)] == \
        [256, 256, 256, 232]
    assert [min(s, max(0, 700 - r * s)) for r in range(c)] == \
        [256, 256, 188, 0]
    assert ap.k4_plan(2, 8, SMS) == (1, 8)


def test_k4_plan_refuses_what_no_block_holds():
    """A Tp whose sixteenth part is longer than ``K4_SPAN`` is refused (C =
    0), at any SM count; a long Tp that a larger cluster brings under it
    takes that cluster; the turbo shapes are far inside."""
    for sms in (1, SMS):
        assert ap.k4_plan(20, 16 * ap.K4_SPAN + 8, sms)[0] == 0
        assert ap.k4_plan(20, 16 * ap.K4_SPAN, sms) == (16, ap.K4_SPAN)
        assert ap.k4_plan(20, 3008, sms)[0] >= 2
        assert ap.k4_plan(20, 1536, sms)[0] > 0
