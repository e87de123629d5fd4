"""Finding a cell's parts by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own under the benchmark's folder:

* the configuration's file, named by its ``file`` in ``BENCHMARK.json``
  (``configs/<config>.json``), and ``fixtures/<config>.py`` (its ``make``);
* ``traffic/<traffic>.json``, whose ``entry`` together with the
  configuration's ``features`` names ``entries/<entry>_<features>.py``;
* ``limits/<config>/<traffic>.json``, the limits of the cell's checks;
* ``layer_metrics/<metric>.py`` (its ``read``) for each per-layer metric.

A quantity that cells of different pacing report under different bounds
is one metric per pacing, ``<quantity>.<pacing>`` (``scored_pairs_per_s``
and ``scored_pairs_per_s.card_paced``); the harness reads every such name
as ``<quantity>``, with the one reader ``layer_metrics/<quantity>.py``.
So a new cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent  # the benchmark's folder


def load_module(path: pathlib.Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def quantity(metric: str) -> str:
    """The quantity a metric name reports: the name before its first dot."""
    return metric.split(".", 1)[0]


def _mod_name(kind: str, name: str) -> str:
    return f"regbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    bench: pathlib.Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: "list[dict]"
    per_layer: "list[dict]"

    @property
    def name(self) -> str:
        return self.workload["name"]

    def entry(self):
        """The module that drives this cell's traffic through the program."""
        key = f"{self.traffic['entry']}_{self.config['features']}"
        return load_module(self.bench / "entries" / f"{key}.py", _mod_name("entry", key))

    def fixture(self):
        """The module whose ``make(config, seed, device)`` builds the inputs."""
        name = self.config["name"]
        return load_module(self.bench / "fixtures" / f"{name}.py", _mod_name("fixture", name))

    def metrics(self, trace: bool) -> "list[dict]":
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones (a metric with ``workloads`` only in
        those cells)."""
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's quantity."""
        q = quantity(metric)
        return load_module(self.bench / "layer_metrics" / f"{q}.py", _mod_name("metric", q)).read


def load_cell(root: pathlib.Path, workload: str, bench: "pathlib.Path | None" = None) -> Cell:
    """The cell called ``workload`` of ``root/BENCHMARK.json``."""
    root = pathlib.Path(root)
    bench = HERE if bench is None else pathlib.Path(bench)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    w = cells[workload]
    files = {c["name"]: c["file"] for c in spec["configs"]}
    config = json.loads((root / files[w["config"]]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / w["config"] / f"{w['traffic']}.json").read_text())
    config["name"] = w["config"]
    return Cell(bench, w, config, traffic, limits["limits"], spec["end_to_end"],
                spec["per_layer"])
