"""Tests of the benchmark's harness, on the CPU at small sizes.

Run from the repository root:

    python -m pytest regbench/tests -q

A test marked ``card`` needs a CUDA card and skips without one."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: small sizes of the two configurations, every width kept where it can be
TINY = {
    "abdomenctct-semantic": dict(shape=[24, 20, 32], labels=4, warp_ctrl=[3, 3, 3],
                                 noise_ctrl=[4, 4, 4], warp_max_vox=2.0, noise_max_vox=1.0),
    "nlst-mind": dict(shape=[28, 24, 28], keypoints=60, tree_depth=4, root_radius_vox=1.5,
                      breathing_max_vox=[2.0, 1.0], random_ctrl=[3, 3, 3], random_max_vox=0.5),
}


#: fewer settings a call, so that a run here takes seconds
TINY_TRAFFIC = {"settings": {"first": 4}, "check": {"cases": 3, "settings": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    # one thread a test process: several workers share the host's cores
    import torch

    torch.set_num_threads(1)


def make_tiny_root(dest: pathlib.Path) -> pathlib.Path:
    """A checkout-like folder with ``BENCHMARK.json`` and a copy of the
    benchmark whose configurations are cut to :data:`TINY`."""
    shutil.copytree(BENCH, dest / "regbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, sizes in TINY.items():
        path = dest / "regbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    for path in (dest / "regbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        for key, sub in TINY_TRAFFIC.items():
            mix[key].update({k: v for k, v in sub.items() if k in mix[key]})
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture()
def tiny_root(tmp_path) -> pathlib.Path:
    return make_tiny_root(tmp_path)


def tiny_cell(root: pathlib.Path, workload: str):
    from rb.spec import load_cell

    return load_cell(root, workload, root / "regbench")
