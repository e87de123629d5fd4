"""Spatial sharding of one registration on the CPU:
``register_pairs_sharded(..., shard_space=True)`` and
``convexadam_torch/parallel/spatial.py``.

Four ranks of a gloo process group run as subprocesses
(``tests/torch_spatial_worker.py``: a free localhost port, a 60 s
process-group timeout, one thread a rank, and a deadline here, so that a
stuck rank fails the test instead of hanging the suite).  Every rank's
stages and field are held to the one-process pipeline to the bit, and the
field to the JAX package's ``register_pairs_sharded(shard_space=True)`` on
its 8 virtual CPU devices within the envelope of
``tests/test_torch_pipeline.py``.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convexadam_torch.parallel import spatial
from convexadam_tpu.parallel import batch as jbatch
from convexadam_tpu.pipeline import convex_adam as jpipe
from tests import torch_spatial_worker as w

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_RANKS = 4
_DEADLINE_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' results, and the JAX package's sharded fields
    computed here while the ranks run."""
    root = tmp_path_factory.mktemp("space_ranks")
    port = _free_port()
    procs = []
    for rank in range(_RANKS):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(_RANKS), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_spatial_worker", str(root)],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.monotonic()
    try:
        jcfg = jpipe.ConvexAdamConfig(**w.BASE)
        jax_fields = {}
        for grid, n_pairs in (((1, 4), 1), ((2, 2), 2)):
            vols, movs = w.pairs(n=n_pairs)
            mesh = jbatch.make_mesh(*grid)
            jax_fields[grid] = np.asarray(jbatch.register_pairs_sharded(
                jnp.asarray(vols), jnp.asarray(movs), jcfg, mesh, shard_space=True))
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
    for rank in range(_RANKS):
        with open(root / f"rank{rank}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    refs = {}
    for r in ranks:
        refs.update(r["refs"])
    return ranks, refs, jax_fields


# ---------------------------------------------------------------------------
# (a) the exchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_joins_uneven_slabs(four_ranks, dtype):
    """Slabs of 3, 4, 1 and 3 rows, padded to 4 for the all-gather: every
    rank holds the whole tensor, bfloat16 bit for bit."""
    ranks, _, _ = four_ranks
    for r in ranks:
        assert torch.equal(r[("gather", str(dtype))], w.known(dtype))


@pytest.mark.parametrize("lo,hi", w.EXCHANGE_HALOS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exchange_halo_takes_the_neighbours_rows(four_ranks, dtype, lo, hi):
    """Each rank's slab grown by ``lo`` rows before and ``hi`` after, from
    however many ranks hold them (the one-row slab is passed over), and
    nothing past the first and last row."""
    ranks, _, _ = four_ranks
    x = w.known(dtype)
    n = x.shape[1]
    for rank, r in enumerate(ranks):
        s, e = w.exchange_ranges()[rank]
        got, first = r[("halo", str(dtype), lo, hi)]
        a, b = max(0, s - lo), min(n, e + hi)
        assert first == a
        assert torch.equal(got, x[:, a:b])


def test_exchange_halo_and_gather_on_one_rank():
    """Without a process group a slab is the whole volume: nothing to take."""
    x = w.known()
    got, first = spatial.exchange_halo(x, 2, 3, [(0, x.shape[1])])
    assert got is x and first == 0
    assert spatial.gather_rows(x, [(0, x.shape[1])]) is x


# ---------------------------------------------------------------------------
# (b) every stage against the one-process pipeline
# ---------------------------------------------------------------------------

_STAGES = ("features", "convex", "ic", "adam", "final")


@pytest.mark.parametrize("name", [c[0] for c in w.CONFIGS])
def test_every_stage_equals_one_process(four_ranks, name):
    """MIND features (with the variance's global mean), the convex field of
    both directions, inverse consistency, the Adam field and the final
    field of every rank equal the one-process run's to the bit, and
    ``register_pairs_sharded``'s field equals ``register_slab``'s."""
    ranks, refs, _ = four_ranks
    ref = refs[name]
    for rank, r in enumerate(ranks):
        got = r["stages"][name]
        assert set(got) == set(ref), (set(got), set(ref))
        for stage in _STAGES:
            if stage not in ref:
                continue
            a, b = got[stage], ref[stage]
            for x, y in zip(a, b) if isinstance(b, tuple) else ((a, b),):
                np.testing.assert_array_equal(x, y, err_msg=f"rank {rank} {stage}")
        np.testing.assert_array_equal(r["fields"][name][0], ref["final"])


def test_slab_plan_units():
    """The plan's slab edges at the default config (unit 6) and the test
    config (unit 4); uneven counts and rows past the last unit go as
    documented; the Adam-grid and coarse rows follow."""
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

    assert spatial.slab_unit(ConvexAdamConfig()) == 6
    assert spatial.slab_unit(ConvexAdamConfig(adam_sample_stride=2, grid_sp=4)) == 4
    assert spatial.slab_unit(ConvexAdamConfig(lambda_weight=0, grid_sp=5)) == 5
    plan = spatial.slab_plan(192, 6, 4, 3)
    assert plan.rows() == [(0, 48), (48, 96), (96, 144), (144, 192)]
    plan = spatial.slab_plan(46, 4, 4, 0)
    assert plan.rows() == [(0, 12), (12, 24), (24, 36), (36, 46)]
    assert plan.rows(4) == [(0, 3), (3, 6), (6, 9), (9, 11)]
    assert plan.rows(2) == [(0, 6), (6, 12), (12, 18), (18, 23)]
    assert spatial.slab_plan(20, 4, 4, 0).rows() == [(0, 8), (8, 12), (12, 16), (16, 20)]


def test_plans_of_the_run(four_ranks):
    ranks, _, _ = four_ranks
    assert ranks[0]["plans"]["default"] == [(0, 12), (12, 24), (24, 36), (36, 48)]
    assert all(r["joined"] is True for r in ranks)


# ---------------------------------------------------------------------------
# (c) other grids and shapes; the JAX package
# ---------------------------------------------------------------------------

def test_pair_and_space_grid_equals_one_process(four_ranks):
    """Two pairs on a (pair 2, space 2) grid: every rank holds both fields,
    each equal to its one-process field to the bit."""
    ranks, _, _ = four_ranks
    for r in ranks:
        np.testing.assert_array_equal(r["grid22"], ranks[0]["grid22_ref"])


def test_uneven_slabs_equal_one_process(four_ranks):
    """44 rows in slabs of 12, 12, 12 and 8: the field to the bit."""
    ranks, _, _ = four_ranks
    for r in ranks:
        np.testing.assert_array_equal(r["short"][0], ranks[1]["short_ref"])


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_sharded_field_matches_jax_sharded(four_ranks, grid):
    """The port's sharded field against the JAX package's
    ``register_pairs_sharded(shard_space=True)`` on the same grid of its
    virtual devices, within ``tests/test_torch_pipeline.py``'s envelope:
    max under 0.05 voxels, mean under 1e-3."""
    ranks, _, jax_fields = four_ranks
    ref = jax_fields[grid]
    for r in ranks:
        got = r["fields"]["default"] if grid == (1, 4) else r["grid22"]
        assert got.shape == ref.shape
        err = np.abs(got - ref)
        assert err.max() < 0.05, err.max()
        assert err.mean() < 1e-3, err.mean()


# ---------------------------------------------------------------------------
# (d) too few slabs
# ---------------------------------------------------------------------------

def test_too_few_units_raise(four_ranks):
    """12 rows hold three slabs of 4 rows: four ranks refuse, naming the
    shape, before any exchange."""
    ranks, _, _ = four_ranks
    for r in ranks:
        assert r["too_short"] is not None and "12 rows" in r["too_short"]
        assert "4 ranks" in r["too_short"]
    with pytest.raises(ValueError, match="fewer than the 4 ranks"):
        spatial.slab_plan(12, 4, 4, 0)


# ---------------------------------------------------------------------------
# the two kernels' new arguments, through their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_cost_volume_moving_row_offset(rng, q, metric):
    """The fixed rows ``a .. b - 1`` with the moving rows they reach (from
    the fixed row ``mov_row0``) give those rows of the whole volume's cost
    volume and of a candidate block, to the bit, at a global edge and
    inside; a moving slab a row short of them gives the whole volume's with
    that row of the moving features zero."""
    from convexadam_torch.kernels.cost_volume import cost_volume_block_plain, cost_volume_plain

    f = torch.from_numpy(rng.standard_normal((3, 9, 5, 6)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((3, 9, 5, 6)).astype(np.float32))
    K, h = 2 * q + 1, f.shape[1]
    whole = cost_volume_plain(f, m, q, metric)
    for a, b in ((0, 4), (3, 7), (6, 9)):
        ma, mb = max(0, a - q), min(h, b + q)
        fs, ms = f[:, a:b].contiguous(), m[:, ma:mb].contiguous()
        assert torch.equal(cost_volume_plain(fs, ms, q, metric, ma - a), whole[:, a:b])
        for kh in range(K):
            block = cost_volume_block_plain(fs, ms, q, kh, 1, metric, ma - a)
            ref = whole.reshape(K, K, K, h, 5, 6)[:, :, kh, a:b]
            assert torch.equal(block.reshape(ref.shape), ref)
        if mb - ma > 1:
            cut = m.clone()
            cut[:, ma] = 0
            short = cost_volume_plain(fs, m[:, ma + 1:mb].contiguous(), q, metric, ma + 1 - a)
            assert torch.equal(short, cost_volume_plain(f, cut, q, metric)[:, a:b])


@pytest.mark.parametrize("stride", [1, 2])
def test_data_term_first_row(rng, stride):
    """The data term of lattice rows ``row0 .. row0 + n - 1``: those rows of
    the whole lattice's gradient to the bit, and the slabs' ``sum(res^2)``
    add up to the whole lattice's."""
    from convexadam_torch.kernels.warp import sub_extent, warp_ssd_loss_grad_plain

    C, H, W, D = 3, 13, 7, 9
    mov = torch.from_numpy(rng.standard_normal((C, H, W, D)).astype(np.float32))
    sub = tuple(sub_extent(n, stride) for n in (H, W, D))
    disp = torch.from_numpy((rng.random((3, *sub)) * 6 - 3).astype(np.float32))
    fix = torch.from_numpy(rng.standard_normal((C, *sub)).astype(np.float32))
    fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
    ssq, rows = warp_ssd_loss_grad_plain(mov, disp, fix.reshape(C, -1), fac, 0.25, stride)
    total = 0.0
    for r0, r1 in ((0, 2), (2, 5), (5, sub[0])):
        s, part = warp_ssd_loss_grad_plain(mov, disp[:, r0:r1].contiguous(),
                                           fix[:, r0:r1].reshape(C, -1), fac, 0.25, stride, r0)
        assert torch.equal(part, rows.reshape(3, *sub)[:, r0:r1].reshape(3, -1))
        total += float(s)
    assert total == pytest.approx(float(ssq), rel=1e-6)

