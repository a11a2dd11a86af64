"""The port's native snapshots and GGML writer on the CPU:
``WhisperEngine.save_native``/``from_native`` (``core/native_ckpt.py``, the
parameter tree as one safetensors file written by ``core/hf.py``'s own
writer, ``meta.json`` as the JAX package writes it) round trip a float, an
int8 and a bf16 engine bit for bit and transcribe alike; a snapshot's
transcript equals the JAX package's on the same GGML file at f32; and
``params_to_ggml_tensors`` -> ``write_ggml`` -> ``from_ggml`` is the
identity, its tensors equal to the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = tmp_path_factory.mktemp("m") / "m.bin"
    write_tiny_checkpoint(str(path))
    return str(path)


def _engine(path, quant, dtype=torch.float32):
    from nobs_whisper_torch.api import WhisperEngine
    eng = WhisperEngine.from_ggml(path, dtype=dtype, device="cpu")
    return eng.quantize() if quant else eng


@pytest.mark.parametrize("quant", [False, True])
def test_native_checkpoint_roundtrip(tmp_path, ckpt, quant):
    """The reference's round trip (``tests/test_tools.py``) on the port:
    same config, vocabulary and parameters bit for bit, dtypes and the
    quantized structure kept, the same text from both engines."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core.native_ckpt import flatten
    from nobs_whisper_torch.utils.testing import speech_like_audio
    eng = _engine(ckpt, quant)
    snap = str(tmp_path / "snapshot")
    eng.save_native(snap)
    eng2 = WhisperEngine.from_native(snap, device="cpu")
    assert eng2.cfg == eng.cfg
    assert eng2.tokenizer._vocab == eng.tokenizer._vocab
    assert eng2.compute_dtype == torch.float32
    a, b = flatten(eng.params), flatten(eng2.params)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert ("tok_emb_q" in eng2.params["decoder"]) == quant
    if quant:
        assert eng2.params["encoder"]["blocks"]["fc1_w"]["q"].dtype == \
            torch.int8
    audio = speech_like_audio(0.5, seed=1)
    assert (eng.transcribe(audio, language="en").text
            == eng2.transcribe(audio, language="en").text)


def test_native_snapshot_bf16_keeps_dtype(tmp_path, ckpt):
    """A bf16 engine's snapshot stores BF16 leaves (the header says so) and
    loads back as a bf16 engine, leaves bit for bit."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core.native_ckpt import PARAMS_FILE, flatten
    eng = _engine(ckpt, True, torch.bfloat16)
    snap = str(tmp_path / "s")
    eng.save_native(snap)
    with open(os.path.join(snap, PARAMS_FILE), "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    dtypes = {v["dtype"] for k, v in header.items() if k != "__metadata__"}
    assert dtypes == {"BF16", "F32", "I8"}
    assert header["decoder.blocks.q_w.q"]["dtype"] == "I8"
    assert header["decoder.blocks.q_w.s"]["dtype"] == "F32"
    eng2 = WhisperEngine.from_native(snap, device="cpu")
    assert eng2.compute_dtype == torch.bfloat16
    a, b = flatten(eng.params), flatten(eng2.params)
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
               for k in a)


def test_native_meta_matches_reference_layout(tmp_path, ckpt):
    """``meta.json`` carries the reference's keys, and its config and
    vocabulary read back through the JAX package's own types; the params
    file is a valid safetensors file (read by the ``safetensors`` package
    where this machine has it, and by the port's numpy reader)."""
    from nobs_whisper_tpu.core.config import WhisperConfig as JaxConfig
    from nobs_whisper_torch.core.hf import load_safetensors
    from nobs_whisper_torch.core.native_ckpt import PARAMS_FILE
    eng = _engine(ckpt, False)
    snap = str(tmp_path / "s")
    eng.save_native(snap)
    with open(os.path.join(snap, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"config", "vocab_b64", "format_version"}
    assert meta["format_version"] == 1
    assert JaxConfig(**meta["config"]).n_vocab == eng.cfg.n_vocab
    path = os.path.join(snap, PARAMS_FILE)
    ours = load_safetensors(path)
    np.testing.assert_array_equal(
        ours["decoder.tok_emb"], eng.params["decoder"]["tok_emb"].numpy())
    st = pytest.importorskip("safetensors.torch")
    lib = st.load_file(path)
    assert torch.equal(lib["encoder.blocks.fc1_w"],
                       eng.params["encoder"]["blocks"]["fc1_w"])


def test_from_native_refuses_other_snapshots(tmp_path, ckpt):
    """A directory without the port's params file (the JAX package's orbax
    snapshots among them) raises, saying so."""
    from nobs_whisper_torch.api import WhisperEngine
    eng = _engine(ckpt, False)
    snap = tmp_path / "s"
    eng.save_native(str(snap))
    (snap / "params.safetensors").rename(snap / "params")
    with pytest.raises(FileNotFoundError, match="orbax"):
        WhisperEngine.from_native(str(snap), device="cpu")


def test_native_snapshot_transcript_matches_jax(tmp_path, ckpt):
    """The port's transcript from a native snapshot equals the JAX
    package's transcript of the same GGML file at f32 (greedy, the
    fallback ladder off: sampled rungs differ across packages by
    design)."""
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JaxOptions
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.utils.testing import speech_like_audio
    snap = str(tmp_path / "s")
    _engine(ckpt, False).save_native(snap)
    eng = WhisperEngine.from_native(snap, device="cpu")
    ref = JaxEngine.from_ggml(ckpt, dtype=jnp.float32)
    audio = speech_like_audio(1.2, seed=4)
    got = eng.transcribe(audio, language="en",
                         opts=DecodeOptions(temperature_increment=0.0))
    want = ref.transcribe(audio, language="en",
                          opts=JaxOptions(temperature_increment=0.0))
    assert got.text == want.text
    assert [s.tokens for s in got.segments] == \
        [s.tokens for s in want.segments]


def test_params_to_ggml_roundtrip_and_matches_jax(tmp_path, ckpt):
    """``params_to_ggml_tensors`` -> ``write_ggml`` -> ``from_ggml`` gives
    the same parameter tree back, and its tensors equal the JAX package's
    ``params_to_ggml_tensors`` of the same weights (names, layouts and
    values)."""
    from nobs_whisper_tpu.models.whisper import params_from_ggml as jfrom
    from nobs_whisper_tpu.models.whisper import (
        params_to_ggml_tensors as jto)
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core import ggml
    from nobs_whisper_torch.core.native_ckpt import flatten
    from nobs_whisper_torch.models.whisper import params_to_ggml_tensors
    eng = _engine(ckpt, False)
    src = ggml.read_ggml(ckpt)
    tensors = params_to_ggml_tensors(eng.params, eng.cfg)
    ref = jto(jfrom(src, dtype=jnp.float32), eng.cfg)
    assert tensors.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(tensors[k], np.asarray(ref[k]), k)
    out = str(tmp_path / "back.bin")
    ggml.write_ggml(out, eng.cfg, src.mel_filters, src.vocab, tensors)
    back = WhisperEngine.from_ggml(out, dtype=torch.float32, device="cpu")
    assert back.cfg == eng.cfg
    a, b = flatten(eng.params), flatten(back.params)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="unquantized"):
        params_to_ggml_tensors(eng.quantize().params, eng.cfg)
