"""BENCHMARK.json against the contract's shape, and cells, configurations,
traffic mixes and per-layer metrics found from new files alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import time

import pytest
from conftest import ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_the_contract_keys_and_names():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["regbench"] and spec["command"][1] == "regbench/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in spec["workloads"]]
    reports = {c: {m["name"] for m in spec["end_to_end"] if c in m.get("workloads", cells)}
               for c in cells}
    for c in cells:  # set-up, another end-to-end metric and a per-layer one in every cell
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert "bound" not in m
        assert all(m["moves"] in reports[c] for c in m.get("workloads", cells)), m


@pytest.mark.parametrize("workload", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = tiny_cell(ROOT, workload)
    assert cell.entry().Session and callable(cell.fixture().make)
    assert cell.workload["chips"] == 1
    for m in cell.metrics(trace=True):
        assert callable(cell.reader(m["name"]))
    assert set(cell.limits) >= set(cell.entry().GAPS)
    assert (ROOT / [c for c in _spec()["configs"] if c["name"] == cell.workload["config"]][0]
            ["file"]).is_file()


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_run_from_new_files_alone(tiny_root):
    """A later change adds a configuration, a traffic mix, a per-layer
    metric and a cell as new files and new entries: the harness runs the
    cell and reports the metric, and no file it had changed."""
    from rb.harness import run_cell

    bench = tiny_root / "regbench"
    before = _digests(bench)
    shutil.copy(bench / "fixtures" / "abdomenctct-semantic.py", bench / "fixtures" / "small-abd.py")
    cfg = json.loads((bench / "configs" / "abdomenctct-semantic.json").read_text())
    cfg.update(name="small-abd", labels=3, subjects=5, pairs=[[0, 1], [2, 3]])
    (bench / "configs" / "small-abd.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "sweep1-first12-8pairs.json").read_text())
    mix["settings"]["first"] = 2
    (bench / "traffic" / "sweep1-first2.json").write_text(json.dumps(mix))
    (bench / "limits" / "small-abd").mkdir()
    shutil.copy(bench / "limits" / "abdomenctct-semantic" / "sweep1-first12-8pairs.json",
                bench / "limits" / "small-abd" / "sweep1-first2.json")
    (bench / "layer_metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "small-abd", "source": "test", "file":
                            "regbench/configs/small-abd.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "small", "config": "small-abd", "traffic": "sweep1-first2",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("small")
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "lower",
                              "source": "program_counter", "layer": "sweep engine",
                              "moves": "scored_pairs_per_s", "workloads": ["small"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = tiny_cell(tiny_root, "small")
    line, checks = run_cell(cell, 7, 0.0, True, "cpu", time.perf_counter())
    assert line["attempted"] == 4 and line["metrics"]["calls_in_window"]["value"] == 1.0
    assert "scored_pairs_per_s" not in line["metrics"]  # a traced run reports per-layer ones
    assert all(c.ok for c in checks), checks
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
