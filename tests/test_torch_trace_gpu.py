"""On the card (marked ``gpu``; it skips without one): the program's batch
records and the device trace share a clock. One window batch runs under
``torch.profiler`` recording the CUDA activity alone, started in the
batch's own thread as the benchmark's traced run starts it
(``benchmark/devtrace.py``); every device activity of the batch lies
inside the batch's record, within 0.1 ms.

This file imports neither JAX nor the JAX package; from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_trace_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu
SLACK_NS = 100_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cuda_events(prof):
    from torch.autograd import DeviceType
    return [(ev.name(), ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA]


def test_device_activity_lies_inside_the_batch_record(card, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path / "m.bin")
    write_tiny_checkpoint(path)
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cuda")
    be = BatchedEngine(eng, opts=DecodeOptions(
        sample_len=24, temperature_increment=0.0), max_batch=2,
        max_wait_ms=5.0)
    audio = (np.random.RandomState(3).randn(16000) * 0.2).astype(np.float32)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)   # the first start: here
    run_batch, got = be.batcher._run_batch, {}

    def profiled(batch):
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        try:
            run_batch(batch)
        finally:
            torch.cuda.synchronize()
            prof.stop()
            got["events"] = _cuda_events(prof)
    try:
        be.transcribe(audio, language="en")     # warm
        be.batcher._run_batch = profiled
        be.transcribe(audio, language="en")
    finally:
        be.close()
    rec = GLOBAL_PROFILER.batch_records()[-1]
    events = got["events"]
    assert rec.intervals and len(events) > 100
    first, last = min(s for _, s, _ in events), max(e for _, _, e in events)
    print(f"[clock] {len(events)} device activities, the first "
          f"{(first - rec.start_ns) / 1e3:.1f} us after the record's start, "
          f"the last {(rec.end_ns - last) / 1e3:.1f} us before its end "
          f"(record {(rec.end_ns - rec.start_ns) / 1e6:.3f} ms)")
    for name, s, e in events:
        assert rec.start_ns - SLACK_NS <= s <= e <= rec.end_ns + SLACK_NS, \
            (name, s - rec.start_ns, rec.end_ns - e)
