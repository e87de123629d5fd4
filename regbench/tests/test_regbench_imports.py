"""No run loads JAX or the JAX package; a run that did prints no result."""

from __future__ import annotations

import subprocess
import sys
import types

from conftest import BENCH, ROOT
from rb.imports import forbidden_modules


def test_names_are_compared_whole_by_their_top_level():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "convexadam_tpu.core": 1,
            "convexadam_torch": 1, "convexadam_torch.core": 1, "jaxtyping": 1, "rb.jax": 1}
    assert forbidden_modules(mods) == ["convexadam_tpu.core", "flax", "jax", "jax.numpy",
                                       "jaxlib.xla"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import glob, pathlib\n"
        "from rb import harness, spec, trace, roofline, settings, synth\n"
        "from rb.spec import load_module\n"
        "for p in sorted(glob.glob(%r + '/*/*.py')):\n"
        "    if '/tests/' not in p:\n"
        "        load_module(pathlib.Path(p), 'm_' + pathlib.Path(p).stem.replace('-', '_'))\n"
        "import convexadam_torch.selfconfig.engine, convexadam_torch.selfconfig.paired\n"
        "from rb.imports import forbidden_modules\n"
        "print(forbidden_modules())\n" % (str(BENCH), str(ROOT), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin"})
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "abdct-sweep1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    import run  # regbench/run.py
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr("rb.harness.run_cell", lambda *a, **k: ({}, []))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "abdct-sweep1", "--seed", "1", "--seconds", "1"]) == 3
    cap = capsys.readouterr()
    assert cap.out == "" and "jax" in cap.err
