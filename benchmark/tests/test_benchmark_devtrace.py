"""The reduction of a device trace, and the readers that read it, on a
trace made by hand."""

import pytest

from benchmark import devtrace, harness

import tiny


def test_union_and_gaps():
    iv = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0), ("d", 4.0, 4.5),
          ("e", 6.0, 7.0)]
    busy, gaps = devtrace.busy_and_gaps(iv)
    assert busy == pytest.approx(4.5)         # overlaps counted once
    assert gaps == [(1.0, "c"), (1.5, "e")]
    b = devtrace.breakdown(iv, gaps)
    assert b["device_ops"][0] == ["b", 1.5]
    assert b["idle_gaps"] == [["before e", 1.5], ["before c", 1.0]]


def _run():
    c = harness.load_cell(tiny.ROOT, "turbo-dictation")
    r = harness.Run(cell=c, seconds=10.0, sample_len=48)
    r.batches = [harness.Batch(0.0, 1.0, 4, [10] * 4, 48),
                 harness.Batch(1.0, 2.0, 2, [10] * 2, 48, profiled=True)]
    # one encoder layer's kernels, then a decoder copy, in time order
    r.kernels = [("void nwt::ln_quant_kernel<bf16>(x)", 0.00, 0.01),
                 ("void nwt::proj_wgmma_kernel<128>(m)", 0.01, 0.03),
                 ("void nwt::attn_wgmma_kernel(m)", 0.03, 0.07),
                 ("void nwt::ln_quant_kernel<bf16>(x)", 0.08, 0.09),
                 ("void nwt::mlp_fc1_cluster_kernel<2>(m)", 0.09, 0.15),
                 ("void nwt::mlp_fc2_kernel<1>(m)", 0.15, 0.18),
                 ("void at::native::unrolled_elementwise_kernel<at::native::"
                  "direct_copy_kernel_cuda(x)>(int)", 0.20, 0.30)]
    r.busy_s, r.gaps = devtrace.busy_and_gaps(r.kernels)
    r.span_s = 1.0
    return r


def _read(run, name):
    return harness.reader(run.cell.bench_dir, name).read(run)


def test_readers_on_a_trace_by_hand():
    run = _run()
    assert _read(run, "encoder_ms_per_window.dictation") == pytest.approx(
        170.0 / 2)                            # 0.17 s over 2 windows
    assert _read(run, "decoder_ms_per_step.dictation") == pytest.approx(
        100.0 / 48)
    assert _read(run, "dequant_copy_share.dictation") == pytest.approx(
        100 * 0.10 / 0.27)
    assert _read(run, "idle_share.dictation") == pytest.approx(73.0)
    assert _read(run, "batch_ms_per_step.dictation") == pytest.approx(
        1000.0 / 48)                          # the steady batch only
    from benchmark.metrics_common import block_times
    t = block_times(run)
    assert t["attention"] == pytest.approx(0.07)   # its LN, q/k/v, core
    assert t["mlp"] == pytest.approx(0.10)


def test_rooflines_from_shapes():
    from benchmark.ops import arith
    run = _run()
    m = run.cell.model
    i8, bf, nb = arith.attention_block(2, 1500, m["d_model"])
    want = 100 * m["encoder_layers"] * arith.bound_s(nb, i8, bf) / 0.07
    assert _read(run, "attn_roofline.dictation") == pytest.approx(want)
    run.kernels = []
    assert _read(run, "attn_roofline.dictation") is None
