"""The harness finds everything by name, and prints the contract's line."""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, SEED, TINY_CONFIG

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_entry_has_its_files():
    bench = harness.benchmark()
    for c in bench["configs"]:
        cfg = harness.configuration(c["name"])
        assert cfg["name"] == c["name"] and (ROOT / c["file"]).exists()
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        cell = harness.workload(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["traffic"]["mix"] == w["traffic"] and cell["chips"] == w["chips"]
        mod = harness.traffic(cell["traffic"]["kind"])
        assert all(callable(getattr(mod, f)) for f in ("setup", "window", "check"))
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert all(harness.applies(e, c) for c in m["workloads"] for e in bench["end_to_end"]
                   if e["name"] == m["moves"])


def _run(harness_mod, cell, trace=False, seconds=1.0):
    out = io.StringIO()
    with redirect_stdout(out):
        harness_mod.emit(harness_mod.run_cell(cell, SEED, seconds, trace, device="cpu"))
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_last_line_has_the_contracts_keys(tiny):
    line = _run(tiny, "nq.batch-search")
    assert list(line) == CONTRACT_KEYS + ["checks"]
    assert set(line["metrics"]) == {"qps", "recall_at_10", "index_bytes_per_doc", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["correct"] is True and line["failed"] == 0


def test_traced_line_reads_only_per_layer_metrics(tiny):
    line = _run(tiny, "nq.batch-search", trace=True, seconds=3.0)
    assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
    per_layer = {m["name"] for m in harness.benchmark()["per_layer"]
                 if "nq.batch-search" in m["workloads"]}
    # on the CPU the device's metrics find nothing to read and are left out
    assert set(line["metrics"]) == {"search.batch_ms", "search.expanded_per_query"}
    assert set(line["metrics"]) <= per_layer
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_build_readers_and_empty_device_readers():
    """The build layer's readers on a record as a traced seal run fills it;
    the device's readers find nothing in a record without a device trace."""
    from portbench.trace import Record

    rec = Record()
    rec.values["build.stage_seconds"] = [{"descent": 2.0, "prune": 3.0},
                                         {"descent": 4.0, "prune": 5.0}]
    read = lambda name: harness.metric_reader(name)(rec)
    assert read("build.descent_s") == 3.0 and read("build.prune_s") == 4.0
    assert read("fused_topk_roofline.search") is None and read("idle_pct.search") is None
    assert read("pairwise_tile_roofline.build") is None and read("idle_pct.build") is None


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "nq.batch-search", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nq.batch-search",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


THROWAWAY = '''
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
harness.emit(harness.run_cell("nq.tiny-batch", {seed}, 1.0, {trace}, device="cpu"))
'''


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_new_cell_is_files_and_entries(tmp_path, trace):
    """A throwaway cell, configuration and metric, added as new files and new
    entries of BENCHMARK.json, run with no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = dict(harness.configuration("nq-hybrid-fp32"), name="nq-tiny", **TINY_CONFIG)
    (root / "portbench/configs/nq-tiny.json").write_text(json.dumps(cfg))
    cell = harness.workload("nq.batch-search")
    cell.update(name="nq.tiny-batch", config="nq-tiny")
    cell["traffic"].update(mix="tiny-batch", check_span=2)
    (root / "portbench/workloads/nq.tiny-batch.json").write_text(json.dumps(cell))
    (root / "portbench/metrics/search.calls.py").write_text(
        "def read(record):\n    return len(record.values.get('search.batch_ms', [])) or None\n")
    bench["configs"].append({"name": "nq-tiny", "source": "https://arxiv.org/abs/2104.08663",
                             "file": "portbench/configs/nq-tiny.json", "reduced": ["n_docs"],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "nq.tiny-batch", "config": "nq-tiny",
                               "traffic": "tiny-batch", "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "nq.batch-search" in m["workloads"]:
            m["workloads"].append("nq.tiny-batch")
    bench["per_layer"].append({"name": "search.calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "search", "moves": "qps",
                               "workloads": ["nq.tiny-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = THROWAWAY.format(root=str(root), src=str(ROOT / "src"), seed=SEED, trace=trace)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    want = {"search.calls"} if trace else {"qps", "recall_at_10", "setup_s"}
    assert want <= set(line["metrics"])
