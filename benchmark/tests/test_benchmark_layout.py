"""The harness finds every configuration, mix, metric and limit by the
name ``BENCHMARK.json`` gives: a new one is a new file and an entry."""

import hashlib
import json
import os
import re
import shutil
import time

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


def test_a_new_config_mix_metric_and_cell_need_no_edit(tmp_path):
    """A throwaway configuration, mix, metric and cell, each one new file
    plus an entry in BENCHMARK.json, in a copy of the benchmark: found by
    name and run, and no file of the copy changed."""
    root = tmp_path
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root / "benchmark")
    b = _bench()
    bd = root / "benchmark"
    model = tiny.cell("v3-chunks").model
    (bd / "configs" / "toy.json").write_text(json.dumps(
        dict(model, name="toy")))
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
    for m in b["end_to_end"]:
        if m["name"] == "rtf":
            m["workloads"].append("toy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell(str(root), "toy-cell", bench_dir=str(bd))
    assert cell.model["name"] == "toy" and cell.mix["clients"] == 2
    assert [m["name"] for m in cell.metrics] == ["rtf", "setup_s",
                                                 "toy_answered.toy"]
    out = harness.execute(cell, 2**31 + 5, 2.0, False, time.perf_counter(),
                          device="cpu")
    got = harness.metrics_of(cell, out["run"], "per_layer")
    assert got["toy_answered.toy"]["value"] == len(out["run"].records) > 0
    assert set(harness.metrics_of(cell, out["run"], "end_to_end")) == {
        "rtf", "setup_s"}
    after = _digest(bd)
    assert {k: v for k, v in after.items() if k in before} == before


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
