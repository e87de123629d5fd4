"""The port's multi-device layer on the CPU: ``parallel/``, the
tensor-parallel convex stage, the sweeps over a rank grid, the sweep CLI's
``--mesh`` and ``utils/memory.py``/``utils/devices.py``.

Two ranks of a gloo process group run as subprocesses
(``tests/torch_parallel_worker.py``: a free localhost port, a 60 s
process-group timeout, and ``communicate`` with a deadline here, so that a
stuck rank fails the test instead of hanging the suite).  Their results are
held to the single-process run to the bit, and the tensor-parallel field
also against the JAX package's ``convex_displacement_tp`` on its 8 virtual
CPU devices.
"""

import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from convexadam_torch.core import convex as tconvex
from convexadam_torch.parallel import batch as tbatch
from convexadam_torch.parallel import distributed as tdist
from convexadam_torch.utils import devices as tdevices
from convexadam_torch.utils import memory as tmemory
from convexadam_tpu.core import convex as jconvex
from convexadam_tpu.geometry.io import save_volume_nib_order
from tests import torch_parallel_worker as w

torch.set_num_threads(2)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_DEADLINE_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_config(root: pathlib.Path, out_name: str) -> pathlib.Path:
    """The sweep CLI fixture of ``tests/test_torch_cli.py``: three 32^3
    subjects of two nested boxes, written once per root."""
    rng = np.random.default_rng(0)
    shape = (32, 32, 32)
    for k in range(3):
        o = rng.integers(-2, 3, 3)
        seg = np.zeros(shape, np.float32)
        seg[8 + o[0]: 26 + o[0], 8 + o[1]: 24 + o[1], 8 + o[2]: 24 + o[2]] = 1
        seg[12 + o[0]: 20 + o[0], 12 + o[1]: 20 + o[1], 12 + o[2]: 20 + o[2]] = 2
        for stem in ("pred", "gt"):
            path = root / f"{stem}_{k}.nii.gz"
            if not path.exists():
                save_volume_nib_order(seg, np.eye(4), path)
    config = {
        "topk": [0, 1, 2], "topk_pair": [[0, 1], [1, 2]], "HWD": list(shape),
        "f_predict": str(root / "pred_%d.nii.gz"), "f_gt": str(root / "gt_%d.nii.gz"),
        "num_labels": 3, "output": str(root / f"{out_name}.npz"),
    }
    path = root / f"{out_name}.json"
    path.write_text(json.dumps(config))
    return path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, and the single-process references computed here
    while the ranks run."""
    root = tmp_path_factory.mktemp("ranks")
    cli_mesh = _cli_config(root, "mesh")
    cli_single = _cli_config(root, "single")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(root), str(cli_mesh)],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.monotonic()
    try:
        f, m = (torch.from_numpy(a) for a in w.tp_features())
        refs = {
            ("tp", q, metric): tconvex.convex_displacement(f, m, q, metric=metric,
                                                           smooth_passes=passes).numpy()
            for q, metric, passes in w.TP_CASES
        }
        vols, movs, cfg = w.register_case()
        refs["batched"] = tbatch.register_pairs_batched(vols, movs, cfg, device="cpu").numpy()
        refs["sweeps"] = w.sweeps(None)
        w.cli_sweep(str(cli_single))
        logs = []
        for p in procs:
            left = max(1.0, _DEADLINE_S - (time.monotonic() - t0))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    ranks = []
    for rank in range(2):
        with open(root / f"rank{rank}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return ranks, refs, root


# ---------------------------------------------------------------------------
# the tensor-parallel convex stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,metric,passes", w.TP_CASES)
def test_convex_displacement_tp_equals_dense_and_jax(two_ranks, q, metric, passes):
    """Over two ranks (q = 2: 125 candidates, 63 + 62 and a padded copy of
    the last) every rank's field equals ``convex_displacement``'s to the
    bit.  Against the JAX package's ``convex_displacement_tp`` over its 8
    virtual devices (itself equal to the JAX dense path to the bit,
    ``tests/test_cost_volume.py:225``): the argmins agree, and the fields
    part only by the two packages' box-pass rounding, as the dense and
    streamed paths do (``tests/test_torch_streamed.py``; measured at most
    2.4e-7 voxels), bound 1e-6."""
    ranks, refs, _ = two_ranks
    for r in ranks:
        assert r["joined"] is True
        np.testing.assert_array_equal(r[("tp", q, metric)], refs[("tp", q, metric)])
    f, m = w.tp_features()
    mesh = JMesh(np.array(jax.devices()[:8]), ("disp",))
    ref = np.asarray(jconvex.convex_displacement_tp(jnp.asarray(f), jnp.asarray(m), q, mesh,
                                                    metric=metric, smooth_passes=passes))
    np.testing.assert_allclose(ranks[0][("tp", q, metric)], ref, rtol=0, atol=1e-6)


def test_convex_displacement_tp_one_process_is_the_dense_path(rng):
    """With no group the candidates all lie on this rank: the dense field
    to the bit, on one-hot features full of exact ties too."""
    lab = rng.integers(0, 3, (8, 10, 9))
    eye = np.eye(3, dtype=np.float32)
    f = torch.from_numpy(np.moveaxis(eye[lab], -1, 0).copy())
    m = torch.from_numpy(np.moveaxis(eye[np.roll(lab, (1, -1, 0), (0, 1, 2))], -1, 0).copy())
    for q in (1, 2):
        assert torch.equal(tconvex.convex_displacement_tp(f, m, q),
                           tconvex.convex_displacement(f, m, q))


@pytest.mark.parametrize("lo,hi", [(0, 125), (3, 40), (63, 125), (124, 125), (7, 8)])
def test_candidate_slices_are_the_dense_rows(rng, lo, hi):
    """A rank's candidates, made from one block on the axis-reversed
    features, are the dense volume's rows ``lo:hi`` to the bit."""
    from convexadam_torch.kernels.cost_volume import cost_volume

    f = torch.from_numpy(rng.standard_normal((3, 7, 9, 6)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((3, 7, 9, 6)).astype(np.float32))
    for metric in ("ssd", "sad"):
        full = cost_volume(f, m, 2, metric)
        assert torch.equal(tconvex._candidate_costs(f, m, 2, lo, hi, metric), full[lo:hi])


# ---------------------------------------------------------------------------
# batch registration
# ---------------------------------------------------------------------------

def test_register_pairs_sharded_equals_batched(two_ranks):
    """Three pairs over a pair axis of two (two and one, the last padded):
    every rank holds all three fields, equal to the one-device batch to the
    bit, each of which is a lone ``convex_adam_torch`` call's."""
    from convexadam_torch.pipeline.convex_adam import convex_adam_torch

    ranks, refs, _ = two_ranks
    for r in ranks:
        np.testing.assert_array_equal(r["sharded"], refs["batched"])
    vols, movs, cfg = w.register_case()
    lone = convex_adam_torch(torch.from_numpy(vols[2]), torch.from_numpy(movs[2]), cfg)
    np.testing.assert_array_equal(refs["batched"][2], lone.numpy())


def test_register_pairs_sharded_space_equals_batched(two_ranks):
    """Three pairs, each split along H over a (pair 1, space 2) grid (two
    slabs of 12 rows): every rank holds all three fields, equal to the
    one-device batch to the bit."""
    ranks, refs, _ = two_ranks
    for r in ranks:
        np.testing.assert_array_equal(r["space"], refs["batched"])


def test_register_pairs_sharded_refuses_shard_space(two_ranks):
    """``shard_space=True`` refuses, as a ``ValueError`` naming the rows
    along H, a volume that the one-process run refuses too (4 rows over two
    ranks and 3 rows on one process: grid_sp 4 leaves fewer than 2 coarse
    rows, ``check_grids``)."""
    ranks, _, _ = two_ranks
    for r in ranks:
        assert r["space_refusal"] is not None and "4 rows along H" in r["space_refusal"]
    vols, movs, cfg = w.register_case()
    mesh = tbatch.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="3 rows along H"):
        tbatch.register_pairs_sharded(vols[:, :3], movs[:, :3], cfg, mesh, shard_space=True)


def test_one_process_meshes():
    """Without a process group the grids are one rank; a grid that the
    world cannot fill raises; shards are contiguous blocks."""
    mesh = tbatch.make_sweep_mesh(device="cpu")
    assert (mesh.axis_names, mesh.shape, mesh.rank, mesh.distributed) == (
        ("setting", "pair"), (1, 1), 0, False)
    assert mesh.coord("setting") == mesh.coord("space") == 0 and mesh.size("space") == 1
    assert tbatch.make_mesh(device="cpu").axis_names == ("pair", "space")
    with pytest.raises(ValueError, match="ranks"):
        tbatch.make_sweep_mesh(2, 1, device="cpu")
    assert [list(tbatch.shard_range(3, 2, c)) for c in range(2)] == [[0, 1], [2]]
    assert [list(tbatch.shard_range(1, 2, c)) for c in range(2)] == [[0], []]
    assert tdist.init_distributed(world_size=1) is False and not tdist.is_multiprocess()
    arr = np.zeros(3)
    assert tdist.make_global(arr) is arr


# ---------------------------------------------------------------------------
# the sweeps over a rank grid
# ---------------------------------------------------------------------------

_SWEEP_FIELDS = ("dice", "jstd", "hd95", "rank")


@pytest.mark.parametrize("grid", w.GRIDS)
@pytest.mark.parametrize("sweep", ["stage1_device", "stage1_host", "stage2", "paired1",
                                   "paired2"])
def test_sweeps_over_a_grid_equal_one_process(two_ranks, grid, sweep):
    """Stage 1 (device HD95 with setting batches of two over three
    settings; host HD95), stage 2 and both paired sweeps over (setting 2,
    pair 1) and (setting 1, pair 2) grids, three pairs: ``dice``, ``jstd``,
    ``hd95``, ``rank`` and ``best`` equal the single-process run to the
    bit on both ranks (``times`` differ), as the JAX package's meshed
    sweeps equal its unmeshed ones (``tests/test_selfconfig.py:392``,
    ``:167``)."""
    ranks, refs, _ = two_ranks
    ref = refs["sweeps"][sweep]
    for r in ranks:
        got = r[("sweeps", grid)][sweep]
        for key in _SWEEP_FIELDS:
            np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
        assert got.best == ref.best and got.times.shape == ref.times.shape
        assert (got.times > 0).all()
        for key, arr in ref.cases.items():
            np.testing.assert_array_equal(got.cases[key], arr, err_msg=key)


def test_sweep_cli_mesh_over_two_ranks(two_ranks):
    """``cli.sweep convex --mesh --setting_batch 2`` on two ranks: rank 0
    writes the single-process CLI's arrays (``times`` aside) and is the only
    rank that checkpoints, once a batch of two settings."""
    ranks, _, root = two_ranks
    mesh = np.load(root / "mesh.npz")
    single = np.load(root / "single.npz")
    for key in _SWEEP_FIELDS:
        np.testing.assert_array_equal(mesh[key], single[key], err_msg=key)
    assert ranks[0]["cli_saves"] == [[0, 1], [0, 1, 2]] and ranks[1]["cli_saves"] == []


def test_setting_batch_sets_the_checkpoint_batches(tmp_path, monkeypatch):
    """One process: ``setting_batch`` settings run between two
    checkpoints, and the result does not change."""
    import convexadam_torch.selfconfig.checkpoint as ckpt
    from convexadam_torch.selfconfig import engine

    preds, segs = w.sweep_dataset(K=3)
    saves = []
    save = ckpt.SweepCheckpointer.save
    monkeypatch.setattr(ckpt.SweepCheckpointer, "save",
                        lambda self, st: (saves.append(sorted(st["completed"])), save(self, st)))
    kw = dict(num_labels=2, hd95_mode="host", device="cpu")
    one = engine.run_stage1_sweep(preds, segs, [(0, 1)], w.stage1_settings(),
                                  checkpoint_path=tmp_path / "a", **kw)
    assert saves == [[0], [0, 1], [0, 1, 2]]
    saves.clear()
    two = engine.run_stage1_sweep(preds, segs, [(0, 1)], w.stage1_settings(),
                                  checkpoint_path=tmp_path / "b", setting_batch=2, **kw)
    assert saves == [[0, 1], [0, 1, 2]]
    for key in _SWEEP_FIELDS:
        np.testing.assert_array_equal(getattr(one, key), getattr(two, key))
    with pytest.raises(ValueError, match="setting_batch"):
        engine.run_stage1_sweep(preds, segs, [(0, 1)], w.stage1_settings(), setting_batch=0,
                                **kw)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_stage_timer_and_profile_trace(tmp_path):
    """``stage_timer`` adds each block's host seconds under its name;
    ``profile_trace`` writes a non-empty Chrome trace."""
    timings: dict = {}
    with tmemory.stage_timer("a", timings):
        time.sleep(0.01)
    with tmemory.stage_timer("a", timings):
        pass
    assert 0.01 <= timings["a"] < 5.0
    with tmemory.profile_trace(tmp_path / "trace"):
        torch.ones(64).sum()
    trace = tmp_path / "trace" / "trace.json"
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()


def test_device_usage_and_probe(monkeypatch):
    """``device_usage`` reads the CUDA allocator's current and peak bytes;
    ``probe_device_count`` asks a subprocess (0 here, where torch has no
    CUDA; 0 too when the probe fails or times out)."""
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 1_500_000_000)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 2_250_000_000)
    assert tmemory.device_usage() == "device usage (current/peak): 1.50 / 2.25 GB"
    assert tdevices.probe_device_count(60) == torch.cuda.device_count() == 0
    monkeypatch.setattr(tdevices.sys, "executable", str(_ROOT / "no-such-python"))
    assert tdevices.probe_device_count(5) == 0
