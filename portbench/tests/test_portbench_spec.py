"""The harness finds every part by name, BENCHMARK.json keeps to the
benchmark's contract, and a later change adds a cell and a metric as new
files only."""
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests.tiny import shrink

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    w = spec.workload(cell)
    assert w["chips"] == 1
    assert w["cell"]["config"] == w["config"]
    assert spec.driver(w["cell"]["driver"]).setup
    conf = w["config_file"]
    entry = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert entry["reduced"] == conf["reduced"] and entry["source"] == conf["source"]
    assert spec.reference(conf["reference"]).logits
    spec.model_config(conf)  # the program builds it
    e2e = [m["name"] for m in spec.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, cell, e2e)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert spec.metric(m["name"]).read


def test_every_config_has_a_cell_and_every_metric_a_reader():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert callable(spec.metric(m["name"]).read)
        assert set(m["workloads"]) <= set(CELLS)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric as
    new files and BENCHMARK.json entries: the harness finds and runs them
    without an edit of its own files."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = spec.config("qwen2-0.5b")
    conf["name"] = "qwen2-0.5b-copy"
    (tmp_path / "portbench/configs/qwen2-0.5b-copy.json").write_text(json.dumps(conf))
    cell = spec.cell("qwen2-0.5b.prefill-8k")
    cell["config"] = "qwen2-0.5b-copy"
    cell["traffic"]["gen"] = 3
    (tmp_path / "portbench/cells/qwen2-0.5b-copy.short.json").write_text(json.dumps(cell))
    (tmp_path / "portbench/metrics/waves_seen.py").write_text(
        "def read(run):\n    return float(len(run.work.get('prefill_steps', []))) or None\n")
    bench["configs"].append({"name": "qwen2-0.5b-copy", "source": conf["source"],
                             "file": "portbench/configs/qwen2-0.5b-copy.json",
                             "reduced": conf["reduced"], "why": "a copy"})
    bench["workloads"].append({"name": "qwen2-0.5b-copy.short", "config": "qwen2-0.5b-copy",
                               "traffic": "short", "chips": 1, "why": "a copy"})
    for m in bench["end_to_end"]:
        if m["name"] in ("gen_tok_s", "ttft_p95_ms"):
            m["workloads"].append("qwen2-0.5b-copy.short")
    bench["per_layer"].append({"name": "waves_seen", "unit": "waves", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "gen_tok_s", "workloads": ["qwen2-0.5b-copy.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    w = shrink(spec.workload("qwen2-0.5b-copy.short", tmp_path))
    for trace in (False, True):
        r = harness.run_cell("qwen2-0.5b-copy.short", 7, 0.1, trace, device=torch.device("cpu"),
                             started=time.perf_counter(), root=tmp_path, workload=w,
                             log=lambda *a: None)
        assert r["correct"]
        if trace:
            assert r["metrics"]["waves_seen"]["value"] >= 1
        else:
            assert set(r["metrics"]) == {"gen_tok_s", "ttft_p95_ms", "setup_s"}
        assert list(r)[-1] == "compared"


def test_without_a_card_the_command_prints_no_result():
    """No card (this sandbox): exit 2 and no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(spec.ROOT / "portbench/run.py"), "--workload",
                          CELLS[0], "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 2
    assert "{" not in out.stdout
