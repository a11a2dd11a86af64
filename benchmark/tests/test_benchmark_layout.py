"""The harness finds every configuration, mix, metric and limit by the
name ``BENCHMARK.json`` gives: a new one is a new file and an entry."""

import hashlib
import json
import os
import re
import shutil
import time

import pytest

from benchmark import harness

import tiny

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _bench():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_entry_has_its_files():
    b = _bench()
    bench_dir = os.path.join(tiny.ROOT, "benchmark")
    for c in b["configs"]:
        assert NAME.fullmatch(c["name"])
        with open(os.path.join(tiny.ROOT, c["file"])) as f:
            model = json.load(f)
        assert model["name"] == c["name"] and model["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = harness.load_cell(tiny.ROOT, w["name"])
        assert cell.limits["widest_gap"] > 0
        assert any(m["name"] == "setup_s" for m in cell.metrics)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"])
        r = harness.reader(bench_dir, m["name"])
        assert r.UNIT == m["unit"], m["name"]
        if "moves" in m:
            assert r.MOVES[m["name"].split(".", 1)[1]] == m["moves"]


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


# A model family of another kind: a model file with keys of its own, its
# own vocabulary and special-token layout (99 languages, another vocabulary
# seed), its own weight maker (float32, a leaf at a time on the host) and
# its own least time; served unquantized by the port's WhisperEngine at the
# tiny size and judged by the plain reference.
TOY_FAMILY = '''
import torch

from benchmark.reference.check import judge as plain_judge
from benchmark.reference.tokens import Encoder, byte_level_vocab, layout
from benchmark.weights import _leaves, sinusoids


def vocabulary(model):
    lay = layout(model["ids"])
    vocab = byte_level_vocab(lay, seed=7)
    return lay, vocab, Encoder(vocab, lay.eot)


def _hf(m):
    w, h = m["width"], m["heads"]
    return dict(d_model=w, encoder_attention_heads=h,
                decoder_attention_heads=h, encoder_layers=m["audio_layers"],
                decoder_layers=m["text_layers"], encoder_ffn_dim=4 * w,
                decoder_ffn_dim=4 * w, num_mel_bins=m["mels"],
                vocab_size=m["ids"], max_source_positions=1500,
                max_target_positions=448)


def _tree(m, seed, eot):
    g = torch.Generator().manual_seed(seed + 11)
    tree = {"encoder": {"blocks": {}}, "decoder": {"blocks": {}}}
    for path, shape, kind, scale in _leaves(_hf(m)):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = (torch.randn(shape, generator=g) * scale
                          + (1.0 if kind == "g" else 0.0))
    u = torch.randn(m["width"], generator=g)
    u /= u.norm()
    tree["decoder"]["ln_b"] += 8.0 * u
    tree["decoder"]["tok_emb"][eot] = -4.0 * u
    tree["encoder"]["pos"] = torch.from_numpy(sinusoids(1500, m["width"]))
    return tree


def build_engine(cell, seed, vocab, device):
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core.config import config_from_hparams
    from nobs_whisper_torch.core.tokenizer import WhisperTokenizer
    hf = _hf(cell.model)
    cfg = config_from_hparams(
        n_vocab=hf["vocab_size"], n_audio_ctx=1500,
        n_audio_state=hf["d_model"], n_audio_head=cell.model["heads"],
        n_audio_layer=hf["encoder_layers"], n_text_ctx=448,
        n_text_state=hf["d_model"], n_text_head=cell.model["heads"],
        n_text_layer=hf["decoder_layers"], n_mels=hf["num_mel_bins"])
    return WhisperEngine(params=_tree(cell.model, seed, cfg.eot), cfg=cfg,
                         tokenizer=WhisperTokenizer(vocab, cfg),
                         compute_dtype=torch.float32,
                         device=torch.device(device))


def judge(cell, sample, seed, device, control_bits=None):
    lay, _, enc = vocabulary(cell.model)
    return plain_judge(_tree(cell.model, seed, lay.eot), _hf(cell.model),
                       lay, enc, sample, device, bits=None,
                       control_bits=control_bits)


def batch_least_s(model, prompt_lens, steps):
    return 1e-3 * len(prompt_lens) * steps


def encoder_blocks(model):
    return None
'''


def test_a_new_config_mix_metric_and_cell_need_no_edit(tmp_path):
    """A throwaway model family, configuration, mix, metric and cell, each
    one new file plus an entry in BENCHMARK.json, in a copy of the
    benchmark: found by name and run, and no file of the copy changed."""
    root = tmp_path
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root / "benchmark")
    b = _bench()
    bd = root / "benchmark"
    (bd / "families" / "toy.py").write_text(TOY_FAMILY)
    (bd / "configs" / "toy.json").write_text(json.dumps(dict(
        name="toy", family="toy", width=128, heads=2, audio_layers=2,
        text_layers=2, mels=128, ids=51865, reduced=[],
        serving=dict(quantization="none", compute_dtype="float32",
                     max_batch=2, max_wait_ms=5.0))))
    with open(os.path.join(tiny.ROOT, "benchmark/traffic/chunks32.json")) as f:
        mix = json.load(f)
    mix.update(clients=2, pool=4, batcher=dict(max_batch=2, max_wait_ms=500),
               check=dict(requests=2))
    mix["decode"] = dict(mix["decode"], sample_len=8)
    (bd / "traffic" / "toy_mix.json").write_text(json.dumps(mix))
    (bd / "limits" / "toy-cell.json").write_text(json.dumps(
        {"widest_gap": 0.5, "tokens_judged_min": 16}))
    (bd / "metrics" / "toy_answered.py").write_text(
        'UNIT = "requests"\nMOVES = {"toy": "rtf"}\n\n\n'
        'def read(run):\n    return sum(r.ok for r in run.records)\n')
    b["configs"].append({"name": "toy", "source": "x",
                         "file": "benchmark/configs/toy.json", "reduced": [],
                         "why": "x"})
    b["workloads"].append({"name": "toy-cell", "config": "toy",
                           "traffic": "toy_mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "toy_answered.toy", "unit": "requests",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "rtf",
                           "workloads": ["toy-cell"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("rtf", "mfu.chunks", "attn_roofline.chunks"):
            m["workloads"].append("toy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell(str(root), "toy-cell", bench_dir=str(bd))
    assert cell.model["name"] == "toy" and cell.mix["clients"] == 2
    assert cell.family.__file__ == str(bd / "families" / "toy.py")
    assert [m["name"] for m in cell.metrics] == [
        "rtf", "setup_s", "attn_roofline.chunks", "mfu.chunks",
        "toy_answered.toy"]
    out = harness.execute(cell, 2**31 + 5, 2.0, False, time.perf_counter(),
                          device="cpu")
    run = out["run"]
    assert out["correct"], out["checks"]
    assert out["detail"]["widest_gap"] < 0.01      # float32 on both sides
    got = harness.metrics_of(cell, run, "per_layer")
    assert got["toy_answered.toy"]["value"] == len(run.records) > 0
    wall = sum(x.end - x.start for x in run.batches)
    assert got["mfu.chunks"]["value"] == pytest.approx(100 * sum(
        1e-3 * x.rows * x.steps for x in run.batches) / wall)
    assert set(harness.metrics_of(cell, run, "end_to_end")) == {
        "rtf", "setup_s"}
    # a K1 launch in a profiled batch: no encoder blocks, so no roofline
    run.batches[-1].profiled = True
    run.kernels = [("nwt::attn_wgmma_kernel", 0.0, 1.0)]
    assert "attn_roofline.chunks" not in harness.metrics_of(cell, run,
                                                            "per_layer")
    after = _digest(bd)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_missing_family_fails_with_its_path(tmp_path):
    """A configuration that names a family with no module under
    ``families/`` fails ``load_cell``, naming the file it looked for."""
    root = tmp_path
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    conf = next(c for c in b["configs"] if c["name"] == "large-v3-int8")
    path = root / conf["file"]
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    family="absent")))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(FileNotFoundError) as e:
        harness.load_cell(str(root), "v3-chunks",
                          bench_dir=str(root / "benchmark"))
    assert str(root / "benchmark" / "families" / "absent.py") in str(e.value)


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark (and on
    a machine without a card) the command exits non-zero and prints no
    result."""
    import subprocess
    import sys
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"),
                    tmp_path / "benchmark")
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "turbo-dictation",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
