"""The port's engine entry points against the JAX package's on the CPU:
``from_hf_dir`` on a transformers snapshot, ``with_audio_ctx``,
``transcribe_chunked`` and the ``transcribe`` verb of the CLI. Greedy
only (sampled rungs draw different random numbers in the two
frameworks), f32 compute: tokens and text equal.
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path_factory.mktemp("ckpt") / "ggml-tiny.bin")
    write_tiny_checkpoint(path, seed=9)
    return path


@pytest.fixture(scope="module")
def engines(tiny_ckpt):
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    return (JaxEngine.from_ggml(tiny_ckpt, dtype=jnp.float32),
            WhisperEngine.from_ggml(tiny_ckpt, dtype=torch.float32,
                                    device="cpu"))


def _greedy():
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_torch.decode import rules as trl
    return (jr.DecodeOptions(temperature_increment=0.0),
            trl.DecodeOptions(temperature_increment=0.0))


def _write_hf_snapshot(path):
    """A transformers-format snapshot (config.json, model.safetensors in
    f32, generation_config.json with alignment heads), written as
    tests/test_tools.py::test_from_hf_dir writes one."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration
    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=600, num_mel_bins=80, d_model=64, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=128, encoder_ffn_dim=128,
        max_source_positions=32, max_target_positions=48,
        activation_function="gelu", pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=3, suppress_tokens=None,
        begin_suppress_tokens=None)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    header, blobs, off = {}, [], 0
    for k, v in model.model.state_dict().items():
        raw = v.detach().numpy().astype("<f4").tobytes()
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hjson = json.dumps(header).encode()
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg.to_dict(), f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"alignment_heads": [[1, 0], [1, 3]]}, f)


def test_from_hf_dir_matches_reference(tmp_path):
    """Same config, the same parameters bit for bit, the same alignment
    heads, and logits within the f32 bound of the model parity tests."""
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_tpu.models import whisper as jw
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.models import whisper as tw
    _write_hf_snapshot(str(tmp_path))
    ref = JaxEngine.from_hf_dir(str(tmp_path), dtype=jnp.float32)
    eng = WhisperEngine.from_hf_dir(str(tmp_path), dtype=torch.float32,
                                    device="cpu")
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(ref.cfg)
    assert eng.alignment_heads == ref.alignment_heads == [(1, 0), (1, 3)]
    assert eng.tokenizer is None and eng.device.type == "cpu"
    want = jax.tree_util.tree_flatten_with_path(ref.params)[0]
    for path, leaf in want:
        node = eng.params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=str(path))

    rng = np.random.RandomState(0)
    mel = rng.randn(1, 80, 64).astype(np.float32)
    toks = rng.randint(0, 600, size=(1, 5)).astype(np.int32)
    xa = jw.encode(ref.params, jnp.asarray(mel), ref.cfg)
    want_logits, _ = jw.decoder_forward(
        ref.params, jnp.asarray(toks), jnp.int32(0),
        jnp.zeros((1,), jnp.int32), jw.init_kv_cache(ref.cfg, 1),
        jw.precompute_cross_kv(ref.params, xa, ref.cfg), ref.cfg)
    txa = tw.encode(eng.params, torch.from_numpy(mel), eng.cfg)
    got, _ = tw.decoder_forward(
        eng.params, torch.from_numpy(toks).long(), 0,
        torch.zeros(1, dtype=torch.long), tw.init_kv_cache(eng.cfg, 1),
        tw.precompute_cross_kv(eng.params, txa, eng.cfg), eng.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sidecar,want", [
    (None, None),
    ("[[1, 0], [1, 2]]", [(1, 0), (1, 2)]),
    ("{broken", None),
], ids=["none", "heads", "malformed"])
def test_from_ggml_alignment_heads_match_reference(tmp_path, sidecar, want):
    """A GGML checkpoint's ``<model>.alignment_heads.json`` sidecar gives
    the port's engine the reference engine's heads: none without a
    sidecar, the listed pairs, and none for a malformed file (ignored,
    not fatal)."""
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path / "m.bin")
    write_tiny_checkpoint(path)
    if sidecar is not None:
        (tmp_path / "m.alignment_heads.json").write_text(sidecar)
    ref = JaxEngine.from_ggml(path, dtype=jnp.float32)
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    assert eng.alignment_heads == ref.alignment_heads == want


def test_with_audio_ctx_matches_reference(engines):
    """A truncated context (0.64 s windows): 1.5 s of audio runs three
    windows through the first 32 position rows, as in the reference."""
    from nobs_whisper_torch.utils.testing import speech_like_audio
    ref_eng, eng = engines
    jo, to = _greedy()
    with pytest.raises(ValueError):
        eng.with_audio_ctx(0)
    with pytest.raises(ValueError):
        eng.with_audio_ctx(eng.cfg.n_audio_ctx + 1)
    assert eng.with_audio_ctx(eng.cfg.n_audio_ctx) is eng
    short, ref_short = eng.with_audio_ctx(32), ref_eng.with_audio_ctx(32)
    assert short.cfg.n_audio_ctx == 32 and eng.cfg.n_audio_ctx == 64
    audio = speech_like_audio(1.5, seed=11)
    got = short.transcribe(audio, language="en", opts=to)
    want = ref_short.transcribe(audio, language="en", opts=jo)
    assert [s.tokens for s in got.segments] == \
        [s.tokens for s in want.segments]
    assert [s.seek for s in got.segments] == [s.seek for s in want.segments]
    assert got.text == want.text


def test_transcribe_chunked_matches_reference(engines):
    """Rolling context (chunk N's text is chunk N+1's prompt) and per-chunk
    error isolation: a chunk that fails is skipped on both sides."""
    from nobs_whisper_torch.utils.testing import speech_like_audio
    ref_eng, eng = engines
    jo, to = _greedy()
    chunks = [speech_like_audio(0.6, seed=1), None,
              speech_like_audio(0.9, seed=2), speech_like_audio(0.7, seed=3)]
    want = ref_eng.transcribe_chunked(chunks, language="en",
                                      vocabulary="pallas", opts=jo)
    got = eng.transcribe_chunked(chunks, language="en", vocabulary="pallas",
                                 opts=to)
    assert got == want and got


def test_transcribe_chunked_without_tiktoken_raises(tiny_ckpt, monkeypatch):
    """Without ``tiktoken`` a rolling context or a vocabulary cannot be
    encoded: ``transcribe_chunked`` raises before the first chunk and names
    the ROADMAP item, where per-chunk isolation would have skipped every
    chunk after the first. One chunk with no vocabulary encodes nothing
    and runs."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    monkeypatch.setitem(sys.modules, "tiktoken", None)   # import fails
    eng = WhisperEngine.from_ggml(tiny_ckpt, dtype=torch.float32,
                                  device="cpu")
    to = _greedy()[1]
    chunks = [speech_like_audio(0.6, seed=1), speech_like_audio(0.9, seed=2)]
    for kw in (dict(chunks=chunks),
               dict(chunks=chunks[:1], vocabulary="pallas")):
        with pytest.raises(ImportError, match="ROADMAP.md queue 1, item 14"):
            eng.transcribe_chunked(language="en", opts=to, **kw)
    one = eng.transcribe_chunked(chunks[:1], language="en", opts=to)
    assert one and one == eng.transcribe(chunks[0], language="en",
                                         opts=to).text


def _cli(module, args, home):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "NOBS_WHISPER_TPU_HOME": home,
           "PYTHONPATH": REPO, "HOME": home}
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=600)


def test_cli_transcribe_matches_reference(tiny_ckpt, tmp_path):
    """``transcribe --json`` of the port (``--device cpu``) and of the JAX
    package on the same WAV and checkpoint: same text and segments. A
    registry model id raises on the port and names the ROADMAP item."""
    from nobs_whisper_torch.audio.io import write_wav
    from nobs_whisper_torch.utils.testing import speech_like_audio
    wav = str(tmp_path / "a.wav")
    write_wav(wav, speech_like_audio(1.7, seed=4))
    common = ["transcribe", wav, "--model", tiny_ckpt, "--language", "en",
              "--dtype", "float32", "--temperature-increment", "0",
              "--json"]
    got = _cli("nobs_whisper_torch.cli", common + ["--device", "cpu"],
               str(tmp_path))
    assert got.returncode == 0, got.stderr[-3000:]
    want = _cli("nobs_whisper_tpu.cli", common, str(tmp_path))
    assert want.returncode == 0, want.stderr[-3000:]
    g = json.loads(got.stdout.strip().splitlines()[-1])
    w = json.loads(want.stdout.strip().splitlines()[-1])
    assert g["text"] == w["text"] and g["language"] == w["language"] == "en"
    assert [s["tokens"] for s in g["segments"]] == \
        [s["tokens"] for s in w["segments"]]

    bad = _cli("nobs_whisper_torch.cli",
               ["transcribe", wav, "--model", "large-v3-turbo",
                "--device", "cpu"], str(tmp_path))
    assert bad.returncode != 0
    assert "ROADMAP.md queue 1, item 8" in bad.stderr


@pytest.mark.parametrize("flag", [["--beam-size", "5"], ["--word-timestamps"],
                                  ["--speculative", "3"]])
def test_cli_unported_decoders_raise(tiny_ckpt, tmp_path, flag):
    """Beam, word timestamps and speculative decoding raise through
    ``check_supported`` and name their ROADMAP item."""
    from nobs_whisper_torch import cli
    from nobs_whisper_torch.audio.io import write_wav
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.zeros(8000, np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["transcribe", wav, "--model", tiny_ckpt, "--device", "cpu",
                  "--dtype", "float32", "--language", "en", *flag])


def test_cli_writes_output_formats(tiny_ckpt, tmp_path, capsys):
    """``--output-format`` through the port's copy of the writers."""
    from nobs_whisper_torch import cli
    from nobs_whisper_torch.audio.io import write_wav
    from nobs_whisper_torch.utils.testing import speech_like_audio
    wavs = []
    for i in range(2):
        wavs.append(str(tmp_path / f"a{i}.wav"))
        write_wav(wavs[-1], speech_like_audio(0.8, seed=i))
    out = tmp_path / "out"
    cli.main(["transcribe", *wavs, "--model", tiny_ckpt, "--device", "cpu",
              "--dtype", "float32", "--language", "en", "--batch", "2",
              "--temperature-increment", "0", "--output-format", "srt",
              "--output", str(out)])
    assert sorted(os.listdir(out)) == ["a0.srt", "a1.srt"]
    assert capsys.readouterr().out.count("wrote ") == 2
