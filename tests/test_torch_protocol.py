"""The port's full self-configuring protocol (``convexadam_torch/selfconfig/
protocol.py`` and ``scripts/run_full_protocol_torch.py``) on the CPU.

The fixture is held to ``bench.make_sweep_fixture`` bit for bit; the
protocol (stage 1 over seeded settings, its winner, stage 2 from it) to the
same composition of the JAX package's sweeps on a small fixture, two of the
reference's pairs, host HD95 in both; a run stopped part-way through each
stage and resumed to the run that was never stopped, bit for bit.  Each
tolerance is stated beside its assert with the value measured on the CPU.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import bench
import convexadam_torch.selfconfig.engine as teng
from convexadam_torch.selfconfig import protocol as tprot
from convexadam_tpu.selfconfig import engine as jeng
from convexadam_tpu.selfconfig import settings as jset

torch.set_num_threads(2)

_SHAPE = (24, 20, 32)  # a quarter grid of 6 x 5 x 8 for the 13 organs
_PAIRS = tprot.REF_PAIRS[:2]
_N1, _N2 = 3, 2  # classes (3, 3), (2, 2), (4, 4); grid_sp_adam 2 and 3
_KEYS = ("dice", "jstd", "hd95", "rank")
_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fixture():
    return tprot.make_sweep_fixture(*_SHAPE)


@pytest.fixture(scope="module")
def port_run(fixture):
    """The port's protocol on the small fixture, verbose: the result and
    its printed log."""
    segs, L = fixture
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tprot.run_full_protocol(segs, segs, _PAIRS, L, n1=_N1, n2=_N2, verbose=True,
                                      device="cpu")
    return res, out.getvalue()


@pytest.mark.parametrize("shape", [None, (24, 20, 32, 13, 10, 3)])
def test_fixture_equals_bench(shape):
    """The port's copy of the sweep fixture, at the default 10 subjects of
    192 x 160 x 256 and at a small size of another seed: equal to
    ``bench.make_sweep_fixture`` bit for bit."""
    args = () if shape is None else shape
    got, L = tprot.make_sweep_fixture(*args)
    want, L_ref = bench.make_sweep_fixture(*args)
    assert L == L_ref and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tprot.REF_PAIRS == bench.REF_PAIRS


def test_protocol_matches_jax_composition(fixture, port_run):
    """``run_full_protocol(device="cpu")`` against the JAX package's
    ``run_stage1_sweep`` -> ``settings[best]`` -> ``run_stage2_sweep`` on the
    same fixture, pairs and seeded settings, host HD95 in both.  Measured:
    stage 1 Dice 1.5e-8, SDlogJ 1.2e-5, HD95 9.3e-7 apart, the same winner;
    stage 2 Dice 4.0e-6 (mean 1.3e-7), SDlogJ 1.6e-6, HD95 2.2e-4, the same
    winning variant.  Bounds: those of ``tests/test_torch_selfconfig.py``
    (stage 1: 1e-4, 2e-4, 0.05; stage 2: Dice 5e-3 with a mean of 1e-3,
    2e-4, 0.05)."""
    segs, L = fixture
    res, _ = port_run
    s1 = jset.stage1_settings(_N1)
    j1 = jeng.run_stage1_sweep(segs, segs, _PAIRS, s1, num_labels=L, hd95_mode="host")
    j2 = jeng.run_stage2_sweep(segs, segs, _PAIRS, s1[j1.best], jset.stage2_settings(_N2),
                               num_labels=L, hd95_mode="host")
    assert res.stage1.best == j1.best
    np.testing.assert_allclose(res.stage1.dice, j1.dice, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.stage1.jstd, j1.jstd, rtol=0, atol=2e-4)
    np.testing.assert_allclose(res.stage1.hd95, j1.hd95, rtol=0, atol=0.05)
    assert res.stage2.dice.shape == j2.dice.shape == (_N2 * 16, 2)
    np.testing.assert_allclose(res.stage2.dice, j2.dice, rtol=0, atol=5e-3)
    assert np.abs(res.stage2.dice - j2.dice).mean() < 1e-3
    np.testing.assert_allclose(res.stage2.jstd, j2.jstd, rtol=0, atol=2e-4)
    np.testing.assert_allclose(res.stage2.hd95, j2.hd95, rtol=0, atol=0.05)
    assert res.stage2.best == j2.best

    # the JAX script's keys, and the measurements beside them
    r1, r2, total = res.records
    assert r1["stage"] == 1 and r1["settings"] == _N1 and r1["best"] == repr(
        tprot.stage1_settings(_N1)[res.stage1.best])
    assert r2["stage"] == 2 and r2["variants"] == 16 and r2["best_flat_index"] == res.stage2.best
    for r, sweep in ((r1, res.stage1), (r2, res.stage2)):
        assert r["minutes"] > 0 and r["rescored"] == sweep.rescored == 0
        assert r["sec_per_setting_pair"] == float(np.median(sweep.times)) / len(_PAIRS)
        assert r["resumed_settings"] == 0 and r["rescore_sec"] == 0.0
        assert r["peak_allocated_gb"] is None and r["peak_reserved_gb"] is None  # the CPU
    assert total["stage"] == "total" and total["reference_minutes"] == 60.0
    assert total["minutes"] == pytest.approx(r1["minutes"] + r2["minutes"], rel=1e-3)
    assert total["speedup"] == pytest.approx(60.0 / total["minutes"])


_ENGINE = {name: getattr(teng, name) for name in ("convex_field_semantic", "_stage2_variants")}


def _stop_at(monkeypatch, name: str, call: int, counts: dict):
    """Count the engine's calls of ``name``; the ``call``-th (from 1) raises
    (``call`` 0: none does)."""
    orig = _ENGINE[name]

    def wrapped(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        if counts[name] == call:
            raise RuntimeError(f"injected crash at call {call} of {name}")
        return orig(*args, **kwargs)

    monkeypatch.setattr(teng, name, wrapped)


def test_crash_part_way_through_each_stage_resumes_bit_for_bit(fixture, port_run, tmp_path,
                                                                monkeypatch):
    """A crash at the second pair of stage-1 setting 2 (settings 0 and 1
    checkpointed), a resume that crashes at the second pair of stage-2
    setting 1, and a last resume: ``dice``, ``jstd``, ``hd95``, ``rank`` and
    the winners of both stages equal the run that was never stopped bit for
    bit; each resume runs only the settings that had not finished (counted
    calls), a finished stage whole from its checkpoint (its ``times`` the
    first run's)."""
    segs, L = fixture
    ref, _ = port_run
    P = len(_PAIRS)
    kw = dict(n1=_N1, n2=_N2, checkpoint=tmp_path / "protocol", device="cpu")

    calls: dict = {}
    _stop_at(monkeypatch, "convex_field_semantic", 2 * P + 2, calls)
    with pytest.raises(RuntimeError, match="injected crash"):
        tprot.run_full_protocol(segs, segs, _PAIRS, L, **kw)
    st = np.load(tmp_path / "protocol" / "stage1.ckpt.npz")
    assert st["completed"].tolist() == [0, 1]
    times1 = st["times"].copy()

    calls = {}
    _stop_at(monkeypatch, "convex_field_semantic", 0, calls)
    _stop_at(monkeypatch, "_stage2_variants", P + 2, calls)
    with pytest.raises(RuntimeError, match="injected crash"):
        tprot.run_full_protocol(segs, segs, _PAIRS, L, resume=True, **kw)
    # stage-1 settings 2.. for every pair, then pass A's P coarse fields
    assert calls["convex_field_semantic"] == (_N1 - 2) * P + P
    assert np.load(tmp_path / "protocol" / "stage2.ckpt.npz")["completed"].tolist() == [0]

    calls = {}
    _stop_at(monkeypatch, "convex_field_semantic", 0, calls)
    _stop_at(monkeypatch, "_stage2_variants", 0, calls)
    res = tprot.run_full_protocol(segs, segs, _PAIRS, L, resume=True, **kw)
    assert calls == {"convex_field_semantic": P, "_stage2_variants": (_N2 - 1) * P}
    for got, want in ((res.stage1, ref.stage1), (res.stage2, ref.stage2)):
        for k in _KEYS:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert got.best == want.best
    np.testing.assert_array_equal(res.stage1.times[:2], times1[:2])
    r1, r2, _ = res.records
    assert (r1["resumed_settings"], r2["resumed_settings"]) == (_N1, 1)
    # a restored setting's seconds are the first run's, and so is the median
    assert r1["sec_per_setting_pair"] == float(np.median(res.stage1.times)) / P
    assert r1["best"] == repr(tprot.stage1_settings(_N1)[ref.stage1.best])


def test_resume_of_a_finished_protocol_prepares_nothing(fixture, tmp_path, monkeypatch):
    """Both stages restored whole: no scoring is prepared (no label
    buckets, no HD95 sides), no convex field runs (stage 2 no pass A), and
    the arrays, ranks and winners are the first run's."""
    segs, L = fixture
    kw = dict(n1=1, n2=1, checkpoint=tmp_path / "p", device="cpu")
    first = tprot.run_full_protocol(segs, segs, _PAIRS, L, **kw)
    made = []
    monkeypatch.setattr(teng, "_Scoring", lambda *a, **k: made.append(a))
    calls: dict = {}
    _stop_at(monkeypatch, "convex_field_semantic", 0, calls)
    res = tprot.run_full_protocol(segs, segs, _PAIRS, L, resume=True, **kw)
    assert made == [] and calls == {}
    assert [r["resumed_settings"] for r in res.records[:2]] == [1, 1]
    for got, want in ((res.stage1, first.stage1), (res.stage2, first.stage2)):
        for k in _KEYS + ("times",):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert got.best == want.best and got.rescored == 0


def test_checkpoint_of_another_shape_restarts_visibly(fixture, tmp_path, monkeypatch):
    """A checkpoint of another stage-1 length is ignored, as the engine
    ignores it, and the record says so (``resumed_settings`` 0); the
    stage-2 checkpoint beside it, written after another stage 1, is not
    resumed either (its winner may differ), and stage 2 runs again."""
    segs, L = fixture
    kw = dict(n2=1, checkpoint=tmp_path / "p", device="cpu")
    first = tprot.run_full_protocol(segs, segs, _PAIRS, L, n1=1, **kw)
    calls: dict = {}
    _stop_at(monkeypatch, "_stage2_variants", 0, calls)
    res = tprot.run_full_protocol(segs, segs, _PAIRS, L, n1=2, resume=True, **kw)
    assert [r["resumed_settings"] for r in res.records[:2]] == [0, 0]
    assert calls["_stage2_variants"] == len(_PAIRS)
    assert res.stage1.dice.shape == (2, 2) and first.stage1.dice.shape == (1, 2)
    np.testing.assert_array_equal(res.stage1.dice[0], first.stage1.dice[0])


@pytest.mark.parametrize("labels,K,launches", [(1, 40960, 1), (2, 28672, 1), (3, 36864, 1),
                                                (4, 36864, 2), (2, 8192, 1)])
def test_pruned_launches_of_the_fixture_buckets(labels, K, launches):
    """A case of the full-size fixture scores its 13 organs in 7 buckets
    (K = 8192 .. 40960), one batched pruned call a bucket of 4 searches a
    label; at K = 36864 a launch holds the order tables of 12 searches, so
    the bucket of 4 organs takes two launches (8 a case, as phase 5f counts
    on the card).  ``pruned_launch_count`` is the plan's own cut."""
    from convexadam_torch.kernels.edt import _pruned_split, pruned_launch_count

    assert pruned_launch_count(4 * labels, K, K) == launches
    parts, rows, cut = _pruned_split(4 * labels, K, K)
    assert parts * rows == K and cut[0][0] == 0 and cut[-1][1] == 4 * labels * parts
    assert all(a < e for a, e in cut) and all(cut[i][1] == cut[i + 1][0] for i in range(len(cut) - 1))


def test_summarize_protocol_log_reads_the_port_lines(port_run):
    """The per-class table from the port's own verbose lines: one row per
    stage-1 (grid_sp, disp_hw) and stage-2 (grid_sp_adam, avg_n) class, each
    setting's seconds as printed, then the three records."""
    res, log = port_run
    rows = tprot.summarize_protocol_log(io.StringIO(log))
    s1, s2 = tprot.stage1_settings(_N1), tprot.stage2_settings(_N2)
    want = sorted({(1, s.grid_sp, s.disp_hw) for s in s1} | {(2, s.grid_sp_adam, s.avg_n)
                                                             for s in s2})
    table = [r for r in rows if r.startswith("stage ")]
    assert [r.split(":")[0] for r in table] == [f"stage {a} class {(b, c)}" for a, b, c in want]
    assert sum(int(r.split("n=")[1].split()[0]) for r in table) == _N1 + _N2
    totals = sum(float(r.split("total=")[1].rstrip("s")) for r in table)
    assert totals == pytest.approx(res.stage1.times.sum() + res.stage2.times.sum(), abs=0.01 * (
        _N1 + _N2))  # the lines print each setting's seconds to 0.01
    records = [json.loads(r) for r in rows if r.startswith("{")]
    assert [r["stage"] for r in records] == [1, 2, "total"]
    assert records[1]["best_flat_index"] == res.stage2.best


def _cli():
    spec = importlib.util.spec_from_file_location(
        "run_full_protocol_torch", _ROOT / "scripts" / "run_full_protocol_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_runs_the_protocol_and_prints_the_table(tmp_path, monkeypatch, capsys):
    """``scripts/run_full_protocol_torch.py --device cpu`` on a 16^3 fixture
    (the script's own is 192 x 160 x 256): the setting lines, the three
    records and the table, and its log under ``--checkpoint``; a resume
    reads the whole log back.  Without ``--device`` it asks for the card."""
    orig = tprot.make_sweep_fixture
    monkeypatch.setattr(tprot, "make_sweep_fixture", lambda: orig(16, 16, 16))
    cli = _cli()
    args = ["--settings1", "1", "--settings2", "1", "--device", "cpu",
            "--checkpoint", str(tmp_path / "ck")]
    assert cli.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "card: device cpu"
    assert [json.loads(r)["stage"] for r in out if r.startswith("{")] == [1, 2, "total"] * 2
    assert [r.split(":")[0] for r in out if r.startswith("stage ")] == [
        "stage 1 class (3, 3)", "stage 2 class (2, 1)"]
    assert (tmp_path / "ck" / "protocol.log").read_text().splitlines()[0] == out[0]
    assert cli.main(args + ["--resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any('"resumed_settings": 1' in r for r in out)
    # the table counts the first call's settings, read back from the log
    assert [r.split("n=")[1].split()[0] for r in out if r.startswith("stage ")] == ["1", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--settings1", "1"])


def test_protocol_defaults_to_cuda(fixture, monkeypatch):
    """As every entry of the port: without ``device="cpu"`` it asks for the
    card and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    segs, L = fixture
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprot.run_full_protocol(segs, segs, _PAIRS, L, n1=1, n2=1)
