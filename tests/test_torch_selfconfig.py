"""The port's semantic sweep core (``convexadam_torch/selfconfig``) against
the JAX package, on the CPU.

* the seeded samplers and ``rank.py`` equal the JAX package's bit for bit;
* ``coupled_convex``'s chunked argmin equals the unchunked form bit for bit;
* the per-pair functions, the HD95 label buckets and scorer, and both
  sweeps (host and device HD95, an overflow case) against the JAX functions;
* checkpoint resume, partial resume and a checkpoint the JAX package wrote;
* every entry runs on ``cuda`` unless given ``device="cpu"``.

Inputs are made from a seed with numpy and handed to both packages; every
tolerance is stated beside its assert with the value measured on the CPU.
The one-hot features tie many costs exactly, and the two packages break a
few of those ties differently; that, not the arithmetic, sets the
tolerances of the fields and of the metrics downstream.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convexadam_torch.selfconfig.engine as teng
from convexadam_torch.core import convex as tconvex
from convexadam_torch.core.cost_volume import displacement_mesh
from convexadam_torch.core.smoothing import avg_pool3d
from convexadam_torch.kernels import convex as tfold
from convexadam_torch.selfconfig import checkpoint as tck
from convexadam_torch.selfconfig import rank as trank
from convexadam_torch.selfconfig import settings as tset
from convexadam_tpu.selfconfig import checkpoint as jck
from convexadam_tpu.selfconfig import engine as jeng
from convexadam_tpu.selfconfig import rank as jrank
from convexadam_tpu.selfconfig import settings as jset

torch.set_num_threads(2)

_STAGE1 = [
    tset.Stage1Setting(nn_mult=10, grid_sp=3, disp_hw=2),
    tset.Stage1Setting(nn_mult=10, grid_sp=4, disp_hw=3),
    tset.Stage1Setting(nn_mult=5, grid_sp=2, disp_hw=3),
]
_STAGE2 = [
    tset.Stage2Setting(grid_sp_adam=1, avg_n=1, lambda_weight=1.0),
    tset.Stage2Setting(grid_sp_adam=2, avg_n=2, lambda_weight=0.6),
]
_PAIRS = [(0, 1), (1, 2)]


def _dataset(K=3, n=36, seed=0):
    """K label volumes n^3: nested boxes shifted per subject (the JAX
    package's ``tests/test_selfconfig.py`` fixture at n = 36, scaled)."""
    rng = np.random.default_rng(seed)
    a, b, c, d, r = (round(f * n) for f in (8 / 36, 26 / 36, 13 / 36, 21 / 36, 3 / 36))
    segs = []
    for _ in range(K):
        seg = np.zeros((n, n, n), np.int32)
        o = rng.integers(-r, r + 1, 3)
        seg[a + o[0]: b + o[0], a + o[1]: b + o[1], a + o[2]: b + o[2]] = 1
        seg[c + o[0]: d + o[0], c + o[1]: d + o[1], c + o[2]: d + o[2]] = 2
        segs.append(seg)
    segs = np.stack(segs)
    return segs, segs.copy()  # predictions == ground truth


def _jax_settings(settings):
    return [getattr(jset, type(s).__name__)(**dataclasses.asdict(s)) for s in settings]


@functools.lru_cache(maxsize=None)
def _jax_stage1_host():
    """The JAX package's stage-1 sweep of ``_STAGE1`` on ``_dataset()``,
    host HD95 (two tests read it)."""
    preds, segs = _dataset()
    return jeng.run_stage1_sweep(preds, segs, _PAIRS, _jax_settings(_STAGE1), num_labels=2,
                                 hd95_mode="host")


# ---------------------------------------------------------------------------
# settings, rank, coupled convex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,n,seed", [
    ("stage1_settings", 100, 1004), ("stage1_paired_settings", 100, 1004),
    ("stage2_settings", 75, 2004), ("stage1_settings", 17, 7),
])
def test_samplers_match_jax_and_leave_the_global_rng(sampler, n, seed):
    """The same settings as the JAX package's ``torch.manual_seed`` +
    ``torch.rand`` stream, exactly, and the global torch RNG untouched."""
    torch.manual_seed(123)
    before = torch.get_rng_state()
    got = getattr(tset, sampler)(n, seed)
    assert torch.equal(before, torch.get_rng_state())
    want = getattr(jset, sampler)(n, seed)
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    if sampler == "stage2_settings":
        assert [s.effective_avg_n for s in got] == [s.effective_avg_n for s in want]


def test_variant_decoding_matches_jax():
    assert tset.STAGE2_SNAPSHOT_ITERS == jset.STAGE2_SNAPSHOT_ITERS
    assert tset.STAGE2_SMOOTH_LEVELS == jset.STAGE2_SMOOTH_LEVELS
    assert [tset.decode_adam_variant(v) for v in range(16)] == \
        [jset.decode_adam_variant(v) for v in range(16)]


def test_rank_functions_match_jax_bit_for_bit(rng):
    per_case = rng.random((5, 7))
    np.testing.assert_array_equal(trank.scores_better(per_case), jrank.scores_better(per_case))
    ints = rng.integers(0, 4, 9)
    np.testing.assert_array_equal(trank.rankscore_avgtie(ints), jrank.rankscore_avgtie(ints))
    for hib in (True, False):
        np.testing.assert_array_equal(
            trank.noisy_metric_rank(per_case, hib, repeats=6, rng=np.random.default_rng(3)),
            jrank.noisy_metric_rank(per_case, hib, repeats=6, rng=np.random.default_rng(3)),
        )
    np.testing.assert_array_equal(trank.noisy_metric_rank(per_case[:3], True, repeats=2),
                                  jrank.noisy_metric_rank(per_case[:3], True, repeats=2))
    cols = [rng.random(6) for _ in range(4)]
    np.testing.assert_array_equal(trank.aggregate_ranks(cols), jrank.aggregate_ranks(cols))


def _coupled_unchunked(ssd, ssd_argmin, disp_mesh):
    """``coupled_convex`` as the port ran it before the chunking: the whole
    (3, K^3, N) difference at once."""
    shape = ssd.shape[1:]
    ssd_flat = ssd.reshape(ssd.shape[0], -1)
    disp_soft = avg_pool3d(tconvex._gather_disp(disp_mesh, ssd_argmin), 3, stride=1, padding=1)
    for c in tconvex.COUPLING_COEFFS:
        s = disp_soft.reshape(3, -1)
        diff = disp_mesh[:, :, None] - s[:, None, :]
        sq = diff * diff
        coupled = ssd_flat + c * (sq[0] + sq[1] + sq[2])
        argmin = torch.argmin(coupled, dim=0).reshape(shape)
        disp_soft = avg_pool3d(tconvex._gather_disp(disp_mesh, argmin), 3, stride=1, padding=1)
    return disp_soft


@pytest.mark.parametrize("chunk_voxels", [1, 7, None])
def test_coupled_convex_chunks_equal_the_unchunked_form(rng, monkeypatch, chunk_voxels):
    """Chunking over voxels changes no voxel's arithmetic: bit for bit,
    with a chunk of one voxel, a ragged chunk and the default (one chunk
    here).  Ties are planted so the first minimum decides."""
    q, shape = 2, (5, 6, 7)
    K3 = (2 * q + 1) ** 3
    ssd = rng.integers(0, 5, (K3,) + shape).astype(np.float32)  # many exact ties
    ssd_t = torch.from_numpy(ssd)
    mesh = displacement_mesh(q)
    am = torch.argmin(ssd_t, dim=0)
    if chunk_voxels is not None:
        # the plain coupled argmin, which CPU tensors take, chunks by its own module's bytes
        monkeypatch.setattr(tfold, "COUPLED_CHUNK_BYTES", 3 * K3 * 4 * chunk_voxels)
    got = tconvex.coupled_convex(ssd_t, am, mesh)
    assert torch.equal(got, _coupled_unchunked(ssd_t, am, mesh))


# ---------------------------------------------------------------------------
# per-pair functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coarse", [False, True])
def test_convex_field_semantic_matches_jax(coarse):
    """Within the semantic entry's envelope against the JAX package (mean
    endpoint error < 0.1, p95 < 0.5 voxels, as
    ``tests/test_torch_semantic.py`` holds it).  Measured over these three
    settings and two pairs: mean <= 0.021, p95 <= 0.080 at full
    resolution."""
    preds, _ = _dataset()
    for st in (_STAGE1 if not coarse else _STAGE1[:1]):  # coarse: the stage-2 cache
        for f, m in _PAIRS:
            ref = np.asarray(jeng.convex_field_semantic(
                jnp.asarray(preds[f]), jnp.asarray(preds[m]), jnp.float32(st.nn_mult),
                num_labels=3, grid_sp=st.grid_sp, disp_hw=st.disp_hw, coarse=coarse))
            out = teng.convex_field_semantic(preds[f], preds[m], st.nn_mult, 3, st.grid_sp,
                                             st.disp_hw, coarse=coarse, device="cpu").numpy()
            assert out.shape == ref.shape
            epe = np.sqrt(((out - ref) ** 2).sum(0))
            assert epe.mean() < 0.1, (st, epe.mean())
            assert np.percentile(epe, 95) < 0.5, (st, np.percentile(epe, 95))


def test_evaluate_field_semantic_matches_jax(rng):
    """On one field (the JAX package's convex field), the warped labels and
    the Dice to one float32 ulp (the JAX package divides its float32 sums
    in another order; measured 6e-8); SDlogJ (float32 population std, both)
    within 1e-6 relative (measured 3.4e-7), the negative fraction equal."""
    preds, segs = _dataset()
    disp = np.asarray(jeng.convex_field_semantic(
        jnp.asarray(preds[0]), jnp.asarray(preds[1]), jnp.float32(10.0), num_labels=3,
        grid_sp=3, disp_hw=2))
    disp = disp + rng.normal(0, 0.3, disp.shape).astype(np.float32)  # some folding
    rd, rj, rn, rw = (np.asarray(x) for x in jeng.evaluate_field_semantic(
        jnp.asarray(disp), jnp.asarray(segs[0]), jnp.asarray(segs[1]), 2))
    d, j, n, w = teng.evaluate_field_semantic(disp, segs[0], segs[1], 2, device="cpu")
    np.testing.assert_array_equal(w.numpy(), rw)
    np.testing.assert_allclose(d.numpy(), rd, rtol=1.2e-7, atol=0)
    assert float(n) == float(rn) and float(rn) > 0
    assert abs(float(j) - float(rj)) <= 1e-6 * float(rj), (float(j), float(rj))


def test_robust30_label_sets_match_jax():
    _, segs = _dataset()
    for a, b in zip(teng._robust30_label_sets(segs, _PAIRS, 2),
                    jeng._robust30_label_sets(segs, _PAIRS, 2)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# HD95 over a sweep
# ---------------------------------------------------------------------------

def _random_labels(rng, shape, L, count):
    return rng.integers(0, L + 1, (count,) + shape).astype(np.int32)


def test_label_groups_match_jax(rng):
    """Below the clamp the buckets and the global cap are the JAX package's."""
    segs, _ = _dataset()
    assert teng._suggest_label_groups(segs, 2) == jeng._suggest_label_groups(segs, 2)
    segs = _random_labels(rng, (24, 24, 24), 3, 2)
    assert teng._suggest_label_groups(segs, 3) == jeng._suggest_label_groups(segs, 3)


def test_clamped_cap_is_a_multiple_of_the_tile_and_runs(rng):
    """At 18^3 (5832 voxels) a speckled label needs more than the volume:
    the JAX package clamps its K to 5832, no multiple of the pruned search's
    128-point tile; the port rounds the clamp up to 5888, and the device
    sweep gives the host loop's HD95 (measured: equal; bound 1e-6)."""
    segs = _random_labels(rng, (18, 18, 18), 1, 2)
    groups, _ = teng._suggest_label_groups(segs, 1)
    jgroups, _ = jeng._suggest_label_groups(segs, 1)
    assert groups == [((1,), 5888)] and jgroups == [((1,), 5832)]
    settings = [tset.Stage1Setting(nn_mult=5, grid_sp=2, disp_hw=1)]
    kw = dict(num_labels=1, device="cpu")
    dev = teng.run_stage1_sweep(segs, segs, [(0, 1)], settings, hd95_mode="device", **kw)
    host = teng.run_stage1_sweep(segs, segs, [(0, 1)], settings, hd95_mode="host", **kw)
    assert dev.rescored == 0
    np.testing.assert_allclose(dev.hd95, host.hd95, rtol=0, atol=1e-6)


def test_hd95_scorer_matches_jax_batch_fn(rng):
    """Per case, the port's scorer (fixed side prepared once) against the
    JAX package's batched HD95 with the same buckets: the label mean to 1e-6
    (the JAX mean is float32; measured 0), the same overflow flags."""
    shape, L = (14, 14, 14), 3
    gt = _random_labels(rng, shape, L, 2)
    sw = _random_labels(rng, shape, L, 2)[None]
    groups, kg = teng._suggest_label_groups(gt, L)
    ref_hd, ref_ov = (np.asarray(x) for x in jeng._make_hd95_batch_fn(
        None, L, label_groups=groups, global_surface=kg)(jnp.asarray(gt), jnp.asarray(sw)))
    scorer = teng._HD95Scorer(L, groups, kg, torch.device("cpu"))
    for p in range(2):
        sf = torch.from_numpy(gt[p])
        per_label, over = scorer(sf, scorer.prep(sf), torch.from_numpy(sw[0, p]).to(torch.int16))
        assert per_label.shape == (L,)
        assert abs(float(per_label.double().mean()) - float(ref_hd[0, p])) <= 1e-6
        assert bool(over) == bool(ref_ov[0, p])


def test_resolve_hd95_mode():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert teng._resolve_hd95_mode(None, (192, 160, 256), cuda) == "device"
    assert teng._resolve_hd95_mode(None, (192, 160, 256), cpu) == "host"
    assert teng._resolve_hd95_mode("host", (1040, 64, 64), cuda) == "host"
    assert teng._resolve_hd95_mode(None, (1040, 64, 64), cpu) == "host"
    for mode, dev in ((None, cuda), ("device", cpu)):
        with pytest.raises(ValueError, match="hd95_mode='host'"):
            teng._resolve_hd95_mode(mode, (1040, 64, 64), dev)
    with pytest.raises(ValueError, match="hd95_mode"):
        teng._resolve_hd95_mode("scipy", (8, 8, 8), cpu)


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

def test_stage1_sweep_matches_jax_host():
    """Three settings (one of them at grid_sp 2) x two pairs at 36^3, host
    HD95 in both.  Measured: Dice 2.4e-5, SDlogJ 4.9e-5, HD95 0.017 apart
    (tie-broken fields at two of the six cases); the ranks and the winner
    the same."""
    preds, segs = _dataset()
    ref = _jax_stage1_host()
    res = teng.run_stage1_sweep(preds, segs, _PAIRS, _STAGE1, num_labels=2, hd95_mode="host",
                                device="cpu")
    assert res.dice.shape == (3, 2) and res.hd95.shape == (3,) and res.times.shape == (3,)
    np.testing.assert_allclose(res.dice, ref.dice, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.jstd, ref.jstd, rtol=0, atol=2e-4)
    np.testing.assert_allclose(res.hd95, ref.hd95, rtol=0, atol=0.05)
    np.testing.assert_array_equal(res.rank, ref.rank)
    assert res.best == ref.best and res.rescored == 0 and (res.times > 0).all()
    # the per-case metrics reduce to the per-setting ones
    np.testing.assert_array_equal(res.cases["dice"].mean(axis=(1, 2)), res.dice[:, 0])
    np.testing.assert_allclose(res.cases["hd95"].mean(1), res.hd95, rtol=0, atol=1e-12)
    # registration beats the identity
    from convexadam_torch.core.metrics import dice_coeff
    d0 = float(dice_coeff(torch.from_numpy(segs[0]), torch.from_numpy(segs[1]), 3).mean())
    assert res.dice[res.best, 0] > d0


def test_stage1_sweep_device_hd95_at_18():
    """``hd95_mode="device"`` at 18^3 against the JAX package's device run
    (measured: HD95 and Dice equal) and the port's host loop (HD95 1.1e-7
    apart: float32 distances against float64); bounds 1e-5 and 1e-4."""
    preds, segs = _dataset(n=18)
    pairs, settings = _PAIRS, _STAGE1[:1]
    ref = jeng.run_stage1_sweep(preds, segs, pairs, _jax_settings(settings), num_labels=2,
                                hd95_mode="device")
    dev = teng.run_stage1_sweep(preds, segs, pairs, settings, num_labels=2,
                                hd95_mode="device", device="cpu")
    host = teng.run_stage1_sweep(preds, segs, pairs, settings, num_labels=2,
                                 hd95_mode="host", device="cpu")
    np.testing.assert_allclose(dev.hd95, host.hd95, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev.hd95, ref.hd95, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev.dice, ref.dice, rtol=0, atol=1e-4)
    assert dev.rescored == 0 and dev.best == host.best


def test_stage1_overflow_rescored_exactly(monkeypatch):
    """Caps far too small (one 128-point tile a label): the overflow shows as a
    RuntimeWarning and each flagged case is re-scored exactly, so the
    device sweep gives the host loop's HD95 (as
    ``tests/test_selfconfig.py::test_stage1_sweep_overflow_rescored_exactly``
    holds the JAX package)."""
    rng = np.random.default_rng(11)
    segs = _random_labels(rng, (16, 16, 16), 2, 2)
    settings = [tset.Stage1Setting(nn_mult=5, grid_sp=2, disp_hw=1)]
    kw = dict(num_labels=2, device="cpu")
    host = teng.run_stage1_sweep(segs, segs, [(0, 1)], settings, hd95_mode="host", **kw)
    orig = teng._suggest_label_groups
    monkeypatch.setattr(teng, "_suggest_label_groups",
                        lambda s, L: ([(tuple(range(1, L + 1)), 128)], orig(s, L)[1]))
    with pytest.warns(RuntimeWarning, match="cap overflow"):
        dev = teng.run_stage1_sweep(segs, segs, [(0, 1)], settings, hd95_mode="device", **kw)
    assert dev.rescored == 1 and dev.rescore_sec > 0
    np.testing.assert_allclose(dev.hd95, host.hd95, rtol=0, atol=1e-5)


def test_stage2_sweep_matches_jax_host():
    """Pass A at the first setting, then grid_sp_adam 1 and 2 (120 Adam
    iterations, the smoother bank) x 16 variants on one pair at 36^3.
    Measured: Dice 9.5e-4 (mean 9.4e-5), SDlogJ 5.4e-5 apart, HD95 equal,
    the winner the same: the Adam loops of the two packages drift apart
    where the one-hot data term is flat.  Bounds: 5e-3 (mean 1e-3), 2e-4,
    0.05."""
    preds, segs = _dataset()
    ref = jeng.run_stage2_sweep(preds, segs, _PAIRS[:1], _jax_settings(_STAGE1)[0],
                                _jax_settings(_STAGE2), num_labels=2, hd95_mode="host")
    res = teng.run_stage2_sweep(preds, segs, _PAIRS[:1], _STAGE1[0], _STAGE2, num_labels=2,
                                hd95_mode="host", device="cpu")
    assert res.dice.shape == (32, 2) and res.rank.shape == (32,) and res.hd95.shape == (32,)
    assert res.cases["dice"].shape == (2, 1, 4, 4, 2)
    np.testing.assert_allclose(res.dice, ref.dice, rtol=0, atol=5e-3)
    assert np.abs(res.dice - ref.dice).mean() < 1e-3
    np.testing.assert_allclose(res.jstd, ref.jstd, rtol=0, atol=2e-4)
    np.testing.assert_allclose(res.hd95, ref.hd95, rtol=0, atol=0.05)
    assert res.best == ref.best and np.isfinite(res.dice).all()


_SEEDED_STAGE2 = tset.stage2_settings()


@pytest.mark.parametrize("n", [18, 36])
@pytest.mark.parametrize("setting", [1, 11])
def test_stage2_sweep_grid_3_and_4_match_jax_host(n, setting):
    """Stage 2 at the first seeded settings of grid_sp_adam 3 (setting 1:
    avg_n 3, lambda 0.8) and 4 (setting 11: avg_n 1, lambda 0.4) from pass
    A at the first stage-1 setting, one pair, host HD95, against the JAX
    package.

    grid_sp_adam 3 (6^3 and 12^3 Adam grids), measured: Dice 1.2e-7 (mean
    2.8e-8), SDlogJ 1.2e-7, HD95 4.7e-7, the winner the same; held to
    ``test_stage2_sweep_matches_jax_host``'s bounds.

    grid_sp_adam 4 (4^3 and 9^3 Adam grids): the 60-iteration variants
    agree (Dice 4.2e-5), then the 120-iteration loops part as each parts
    from itself (``test_stage2_adam_grid4_parts_from_jax_as_from_itself``):
    measured Dice 4.3e-3 (mean 1.1e-3), SDlogJ 7.3e-4, HD95 0.20 at 18^3
    and 0 at 36^3.  Bounds: 1e-4 for the first four variants, then Dice
    1e-2 (mean 3e-3), SDlogJ 2e-3, HD95 0.5; the winner is not held (it
    ranks variants whose metrics lie within that spread)."""
    preds, segs = _dataset(n=n)
    st = [_SEEDED_STAGE2[setting]]
    assert st[0].grid_sp_adam == (3 if setting == 1 else 4)
    ref = jeng.run_stage2_sweep(preds, segs, _PAIRS[:1], _jax_settings(_STAGE1)[0],
                                _jax_settings(st), num_labels=2, hd95_mode="host")
    res = teng.run_stage2_sweep(preds, segs, _PAIRS[:1], _STAGE1[0], st, num_labels=2,
                                hd95_mode="host", device="cpu")
    assert res.dice.shape == (16, 2) and np.isfinite(res.dice).all()
    err = np.abs(res.dice - ref.dice)
    if st[0].grid_sp_adam == 3:
        np.testing.assert_allclose(res.dice, ref.dice, rtol=0, atol=5e-3)
        assert err.mean() < 1e-3
        np.testing.assert_allclose(res.jstd, ref.jstd, rtol=0, atol=2e-4)
        np.testing.assert_allclose(res.hd95, ref.hd95, rtol=0, atol=0.05)
        assert res.best == ref.best
    else:
        assert err[:4].max() < 1e-4, err[:4].max()
        assert err.max() < 1e-2 and err.mean() < 3e-3, (err.max(), err.mean())
        np.testing.assert_allclose(res.jstd, ref.jstd, rtol=0, atol=2e-3)
        np.testing.assert_allclose(res.hd95, ref.hd95, rtol=0, atol=0.5)


def _jax_stage2_inputs(shape, grid_sp_adam, offset):
    """The JAX package's stage-2 Adam inputs for pair (0, 1) of
    ``_dataset`` cropped to ``shape``: pass A's coarse field at the first
    stage-1 setting resized to the Adam grid, plus ``offset``; the pooled
    one-hot features; the cost scale."""
    from convexadam_tpu.core.features import label_counts, semantic_features
    from convexadam_tpu.core.smoothing import avg_pool3d as jpool
    from convexadam_tpu.core.warp import resize_trilinear as jresize

    preds, _ = _dataset(n=max(shape))
    f, m = (jnp.asarray(p[:shape[0], :shape[1], :shape[2]]) for p in preds[:2])
    st = _STAGE1[0]
    coarse = jeng.convex_field_semantic(f, m, jnp.float32(st.nn_mult), 3, st.grid_sp, st.disp_hw,
                                        coarse=True)
    ff, fm = semantic_features(f, m, num_labels=3, mult=1.0, dtype=jnp.float32)
    ff, fm = ff * jnp.float32(st.nn_mult), fm * jnp.float32(st.nn_mult)
    g2 = grid_sp_adam
    hr = jresize(coarse, shape, align_corners=False)
    init = jresize(hr, tuple(s // g2 for s in shape), align_corners=False) / g2 + offset
    scale = jnp.sum((label_counts(f, 3) + label_counts(m, 3)) > 0).astype(jnp.float32)
    return jpool(ff, g2, stride=g2), jpool(fm, g2, stride=g2), init, scale


_ADAM_SNAPSHOTS = (60, 120)


def _both_adam_stages(inputs, setting, init=None):
    """The JAX package's and the port's 120-iteration stage-2 Adam loops on
    the same inputs (the port's from ``init`` where given): their snapshots
    at :data:`_ADAM_SNAPSHOTS`."""
    from convexadam_torch.core.adam import adam_instance_optimisation as tadam
    from convexadam_tpu.core.adam import adam_instance_optimisation as jadam

    pf, pm, jinit, scale = inputs
    kw = dict(niter=120, snapshot_iters=_ADAM_SNAPSHOTS, smoother=("bank", setting.avg_n))
    _, ref = jadam(pf, pm, jinit, jnp.float32(setting.lambda_weight), cost_scale=scale, **kw)
    t = [torch.from_numpy(np.array(a)) for a in (pf, pm, jinit)]
    _, out = tadam(t[0], t[1], t[2] if init is None else init, setting.lambda_weight,
                   cost_scale=float(scale), **kw)
    return np.asarray(ref), out.detach().numpy()


def test_stage2_adam_grid4_parts_from_jax_as_from_itself():
    """Why stage 2 at grid_sp_adam 4 parts from the JAX package at 36^3
    (setting 11, a 9^3 Adam grid): not a fault, and not the one-sided
    derivative of ``test_adam_stage_from_jax_init``.  From the JAX package's
    own init plus 0.013 (no sample on a voxel) the first step agrees to
    1.2e-7 voxels and the 60-iteration field to 5.0e-3; by 120 iterations
    the fields lie up to 0.74 voxels apart (mean 9.5e-3).  The port's loop
    from the same init moved by one ulp parts from itself as far (max 0.63,
    mean 9.6e-3), and so does the JAX package's (max 0.26, mean 6.9e-3):
    Adam at ``lr=1`` on a one-hot data term that is flat between label
    edges amplifies rounding.  Bounds: the 60-iteration field within 2e-2;
    at 120 the mean gap to the JAX package under twice the port's own."""
    setting = _SEEDED_STAGE2[11]
    inputs = _jax_stage2_inputs((36, 36, 36), setting.grid_sp_adam, 0.013)
    ref, out = _both_adam_stages(inputs, setting)
    assert np.abs(out[0] - ref[0]).max() < 2e-2
    init = torch.from_numpy(np.array(inputs[2]))
    _, moved = _both_adam_stages(inputs, setting, torch.nextafter(init, init + 1))
    gap, own = np.abs(out[1] - ref[1]).mean(), np.abs(out[1] - moved[1]).mean()
    assert 0 < gap < 2 * own, (gap, own)


def test_stage2_adam_on_a_non_dividing_grid_from_jax_init():
    """Stage 2's Adam loop at grid_sp_adam 3 on 37 x 38 x 40 labels (a
    12 x 12 x 13 Adam grid; no axis divides), setting 1, from the JAX
    package's own init plus 0.013: measured 3.1e-4 voxels apart at most
    over the 60- and 120-iteration snapshots (8.2e-5 at 120).  Bound 1e-3.
    The grid that the data-term kernel meets at 192 x 160 x 256 (64 x 53 x
    85) is of this kind."""
    setting = _SEEDED_STAGE2[1]
    ref, out = _both_adam_stages(_jax_stage2_inputs((37, 38, 40), setting.grid_sp_adam, 0.013),
                                 setting)
    assert out.shape == (2, 3, 12, 12, 13)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_stage2_sweep_device_hd95_at_18():
    """Stage 2 with device HD95 at 18^3 against the port's host loop (equal
    to 1e-5; measured 0) and the JAX package's host run, which its own
    tests hold to its device run (measured: Dice 6e-8, HD95 equal; bounds
    as above)."""
    preds, segs = _dataset(n=18)
    pairs = _PAIRS[:1]
    ref = jeng.run_stage2_sweep(preds, segs, pairs, _jax_settings(_STAGE1)[0],
                                _jax_settings(_STAGE2), num_labels=2, hd95_mode="host")
    kw = dict(num_labels=2, device="cpu")
    dev = teng.run_stage2_sweep(preds, segs, pairs, _STAGE1[0], _STAGE2, hd95_mode="device", **kw)
    host = teng.run_stage2_sweep(preds, segs, pairs, _STAGE1[0], _STAGE2, hd95_mode="host", **kw)
    np.testing.assert_allclose(dev.hd95, host.hd95, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(dev.dice, host.dice)
    np.testing.assert_allclose(dev.dice, ref.dice, rtol=0, atol=5e-3)
    np.testing.assert_allclose(dev.hd95, ref.hd95, rtol=0, atol=0.05)
    assert dev.rescored == 0


def test_stage2_rank_without_hd95_ignores_the_placeholder():
    """With ``compute_hd95=False`` HD95 takes no part in the rank: the
    metric values do not depend on the setting order, nor does the rank of
    any entry whose metric values are unique (entries that tie exactly
    within a metric take their places in the sort's order, as in the
    reference, convexAdam_hyper_util.py:28-31)."""
    preds, segs = _dataset(n=18)
    kw = dict(num_labels=2, compute_hd95=False, device="cpu")
    fwd = teng.run_stage2_sweep(preds, segs, _PAIRS[:1], _STAGE1[0], _STAGE2, **kw)
    rev = teng.run_stage2_sweep(preds, segs, _PAIRS[:1], _STAGE1[0], _STAGE2[::-1], **kw)
    np.testing.assert_array_equal(rev.dice.reshape(2, 16, 2)[::-1].reshape(-1, 2), fwd.dice)
    np.testing.assert_array_equal(rev.jstd.reshape(2, 16, 2)[::-1].reshape(-1, 2), fwd.jstd)
    rank_rev = rev.rank.reshape(2, 16)[::-1].reshape(-1)
    tied = np.zeros(len(fwd.rank), bool)
    for m in (fwd.dice[:, 0], fwd.dice[:, 1], fwd.jstd[:, 0]):
        vals, counts = np.unique(m, return_counts=True)
        tied |= np.isin(m, vals[counts > 1])
    assert (~tied).any()
    np.testing.assert_allclose(rank_rev[~tied], fwd.rank[~tied], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_resume(tmp_path):
    """A resumed sweep skips the completed settings (garbage inputs leave
    the checkpointed metrics as they were), and a partial checkpoint
    recomputes the rest; the file is written atomically, no temporary left."""
    preds, segs = _dataset(n=18)
    settings = _STAGE1[:2]
    kw = dict(num_labels=2, compute_hd95=False, device="cpu")
    ckpt = tmp_path / "sweep_state"
    ref = teng.run_stage1_sweep(preds, segs, _PAIRS[:1], settings, checkpoint_path=ckpt, **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sweep_state.ckpt.npz"]
    garbage = np.roll(preds, 7, axis=1)
    res = teng.run_stage1_sweep(garbage, segs, _PAIRS[:1], settings, checkpoint_path=ckpt,
                                resume=True, **kw)
    np.testing.assert_array_equal(res.dice, ref.dice)
    np.testing.assert_array_equal(res.jstd, ref.jstd)
    np.testing.assert_array_equal(res.times, ref.times)
    assert res.best == ref.best and np.isnan(res.cases["dice"]).all()
    res2 = teng.run_stage1_sweep(garbage, segs, _PAIRS[:1], settings, **kw)
    assert not np.allclose(res2.dice, ref.dice)

    ck = tck.SweepCheckpointer(ckpt)
    st = ck.restore()
    st["completed"] = np.array([0], np.int64)
    st["dice"][1] = -1  # poison the setting left to compute
    ck.save(st)
    res3 = teng.run_stage1_sweep(preds, segs, _PAIRS[:1], settings, checkpoint_path=ckpt,
                                 resume=True, **kw)
    np.testing.assert_array_equal(res3.dice, ref.dice)
    assert np.isnan(res3.cases["dice"][0]).all() and not np.isnan(res3.cases["dice"][1]).any()
    ck.clear()
    assert ck.restore() is None


def test_resume_from_a_jax_checkpoint(tmp_path):
    """The JAX package's ``.ckpt.npz`` fallback file is read as written: a
    resume with garbage inputs returns the JAX sweep's arrays and ranks
    them as the JAX sweep did."""
    ref = _jax_stage1_host()
    ckpt = tmp_path / "jax_sweep"
    jc = jck.SweepCheckpointer(ckpt)
    jc._ocp = None  # its npz fallback: the schema the port reads and writes
    jc.save(dict(dice=ref.dice, jstd=ref.jstd, hd95=ref.hd95, times=ref.times,
                 completed=np.arange(3, dtype=np.int64)))
    assert tck.SweepCheckpointer(ckpt).path == jc._npz
    preds, segs = _dataset()
    res = teng.run_stage1_sweep(np.roll(preds, 5, axis=2), segs, _PAIRS, _STAGE1, num_labels=2,
                                checkpoint_path=ckpt, resume=True, hd95_mode="host",
                                device="cpu")
    for k in ("dice", "jstd", "hd95", "times", "rank"):
        np.testing.assert_array_equal(getattr(res, k), getattr(ref, k))
    assert res.best == ref.best
    # and the JAX package reads the port's file back
    tck.SweepCheckpointer(ckpt).save(jc.restore())
    np.testing.assert_array_equal(jc.restore()["dice"], ref.dice)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_entries_default_to_cuda(monkeypatch):
    """As every entry of the port: without ``device="cpu"`` the sweep and
    its per-pair functions ask for the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    preds, segs = _dataset(n=12)
    calls = [
        lambda: teng.run_stage1_sweep(preds, segs, _PAIRS, _STAGE1[:1], 2),
        lambda: teng.run_stage2_sweep(preds, segs, _PAIRS, _STAGE1[0], _STAGE2[:1], 2),
        lambda: teng.convex_field_semantic(preds[0], preds[1], 10.0, 3, 3, 2),
        lambda: teng.evaluate_field_semantic(np.zeros((3, 12, 12, 12), np.float32), segs[0],
                                             segs[1], 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
