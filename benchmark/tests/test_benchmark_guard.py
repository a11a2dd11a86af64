"""The check that nothing the benchmark runs loads JAX or the JAX package."""

import os

from benchmark import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_module_importing_jax_fails(tmp_path):
    (tmp_path / "bad.py").write_text("import jax.numpy as jnp\n")
    (tmp_path / "worse.py").write_text(
        "from nobs_whisper_tpu.models import whisper\n")
    (tmp_path / "fine.py").write_text(
        "import nobs_whisper_torch\nfrom nobs_whisper_torch.api import x\n")
    found = guard.scan(str(tmp_path))
    assert sorted(f.rsplit(": ", 1)[1] for f in found) == [
        "jax", "nobs_whisper_tpu"]
    assert not any("fine.py" in f for f in found)


def test_top_level_names_are_compared_whole():
    assert guard.loaded(["nobs_whisper_torch", "nobs_whisper_torch.api",
                         "jaxtyping", "numpy"]) == []
    assert guard.loaded(["jax.numpy", "flax", "jaxlib.xla_client",
                         "nobs_whisper_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "nobs_whisper_tpu"]


def test_the_harness_imports_no_jax():
    assert guard.scan(BENCH) == []


def test_the_port_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys; import nobs_whisper_torch.api, "
            "nobs_whisper_torch.pipeline.batched_engine; "
            "from benchmark import guard; print(guard.loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(BENCH), check=True)
    assert out.stdout.strip() == "[]"
