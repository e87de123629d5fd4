"""The port's paired MIND sweeps (``convexadam_torch/selfconfig/paired.py``)
against the JAX package, on the CPU: the keypoint helpers, the MIND convex
field, the per-field metrics, and both sweeps on smooth random volumes
rolled by a known shift with ragged keypoint counts.  Inputs are made from a
seed with numpy; every tolerance is stated beside its assert with the value
measured on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

from convexadam_torch.selfconfig import paired as tpair
from convexadam_torch.selfconfig.engine import convex_field_mind
from convexadam_torch.selfconfig.settings import Stage1PairedSetting, Stage2Setting
from convexadam_tpu.selfconfig import engine as jeng
from convexadam_tpu.selfconfig import paired as jpair
from convexadam_tpu.selfconfig import settings as jset

torch.set_num_threads(2)

_SHIFT = (3, -2, 2)
_STAGE1 = [
    Stage1PairedSetting(mind_r=1, mind_d=2, grid_sp=3, disp_hw=2),
    Stage1PairedSetting(mind_r=2, mind_d=1, grid_sp=4, disp_hw=3),
]
_STAGE2 = [Stage2Setting(grid_sp_adam=2, avg_n=2, lambda_weight=1.0)]


def _case(n=32, kpts=(20, 13), seed=2):
    """Smooth random volumes and their copies rolled by ``_SHIFT``; per pair
    ``kpts[i]`` keypoints inside the crop and their moved positions."""
    rng = np.random.default_rng(seed)
    vols, movs, kfs, kms = [], [], [], []
    for nk in kpts:
        vol = uniform_filter(rng.standard_normal((n, n, n)).astype(np.float32), 2) * 100
        vols.append(vol)
        movs.append(np.roll(vol, _SHIFT, axis=(0, 1, 2)))
        kf = rng.random((nk, 3)).astype(np.float32) * (n - 20) + 10
        kfs.append(kf)
        kms.append(kf + np.array(_SHIFT, np.float32))
    return np.stack(vols), np.stack(movs), kfs, kms


def _jax(settings):
    return [getattr(jset, type(s).__name__)(**dataclasses.asdict(s)) for s in settings]


def test_keypoint_helpers_match_jax(rng):
    kf = rng.random((17, 3)).astype(np.float32) * 20
    km = kf + rng.normal(0, 2, kf.shape).astype(np.float32)
    r = tpair._robust30_keypoints(kf, km)
    np.testing.assert_array_equal(r, jpair._robust30_keypoints(kf, km))
    kf2, km2 = kf[:9], km[:9]
    robust = [r, tpair._robust30_keypoints(kf2, km2)]
    got = tpair._padded_keypoints([kf, kf2], [km, km2], robust, torch.device("cpu"))
    want = jpair._padded_keypoints([kf, kf2], [km, km2], robust)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_convex_field_mind_matches_jax():
    """Within the semantic entry's envelope against the JAX package (mean
    endpoint error < 0.1, p95 < 0.5 voxels).  Measured: mean <= 6.4e-7,
    max <= 3.6e-6 (no exact ties on MIND features)."""
    vols, movs, _, _ = _case()
    for st in _STAGE1:
        ref = np.asarray(jeng.convex_field_mind(
            jnp.asarray(vols[0]), jnp.asarray(movs[0]), mind_r=st.mind_r, mind_d=st.mind_d,
            grid_sp=st.grid_sp, disp_hw=st.disp_hw))
        out = convex_field_mind(vols[0], movs[0], st.mind_r, st.mind_d, st.grid_sp, st.disp_hw,
                                device="cpu").numpy()
        epe = np.sqrt(((out - ref) ** 2).sum(0))
        assert epe.mean() < 0.1 and np.percentile(epe, 95) < 0.5, (st, epe.mean())


def test_field_metrics_match_jax(rng):
    """TRE mean and robust30, SDlogJ and the negative fraction of one
    field with padded keypoints: TRE to 1e-5 relative (measured 2.1e-7),
    SDlogJ to 1e-6 relative (measured 0), the fraction equal."""
    n = 20
    disp = rng.normal(0, 0.8, (3, n, n, n)).astype(np.float32)
    kf = rng.random((2, 11, 3)).astype(np.float32) * (n - 1)
    km = kf + rng.normal(0, 1.5, kf.shape).astype(np.float32)
    mask = np.ones((2, 11), np.float32)
    mask[1, 7:] = 0
    rmask = (rng.random((2, 11)) < 0.3).astype(np.float32) * mask
    sp = np.array([1.0, 1.5, 2.0], np.float32)
    for i in range(2):
        ref = np.asarray(jpair._field_metrics(jnp.asarray(disp), jnp.asarray(kf[i]),
                                              jnp.asarray(km[i]), jnp.asarray(mask[i]),
                                              jnp.asarray(rmask[i]), jnp.asarray(sp)))
        out = tpair._field_metrics(*(torch.from_numpy(x) for x in (disp, kf[i], km[i], mask[i],
                                                                    rmask[i], sp))).numpy()
        np.testing.assert_allclose(out[:2], ref[:2], rtol=1e-5, atol=0)
        np.testing.assert_allclose(out[2], ref[2], rtol=1e-6, atol=0)
        assert out[3] == ref[3] and ref[3] > 0


@pytest.fixture(scope="module")
def sweeps():
    """Both packages' stage-1 and stage-2 paired sweeps on the same case."""
    vols, movs, kfs, kms = _case()
    t1 = tpair.run_stage1_paired_sweep(vols, movs, kfs, kms, _STAGE1, device="cpu")
    j1 = jpair.run_stage1_paired_sweep(vols, movs, kfs, kms, _jax(_STAGE1))
    t2 = tpair.run_stage2_paired_sweep(vols, movs, kfs, kms, _STAGE1[t1.best], _STAGE2,
                                       device="cpu")
    j2 = jpair.run_stage2_paired_sweep(vols, movs, kfs, kms, _jax(_STAGE1)[j1.best],
                                       _jax(_STAGE2))
    tre0 = np.mean([np.sqrt(((kf - km) ** 2).sum(-1)).mean() for kf, km in zip(kfs, kms)])
    return t1, j1, t2, j2, tre0


def test_stage1_paired_sweep_matches_jax(sweeps):
    """Two settings, two pairs with 20 and 13 keypoints: TRE to 1e-4
    voxels (measured 2.4e-7), SDlogJ and the negative fraction to 1e-5
    (measured 2.2e-8), the same rank; the winner beats the initial TRE."""
    t1, j1, _, _, tre0 = sweeps
    assert t1.dice.shape == (2, 2) and t1.times.shape == (2,)
    np.testing.assert_allclose(t1.dice, j1.dice, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t1.jstd, j1.jstd, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t1.rank, j1.rank)
    assert t1.best == j1.best and t1.dice[t1.best, 0] < tre0


def test_stage2_paired_sweep_matches_jax(sweeps):
    """Grid_sp_adam 2, 120 Adam iterations x 16 variants from the stage-1
    winner.  From the same init the two packages' Adam loops agree to 1e-5
    voxels for 30 iterations, then part by up to 0.04 voxels at 120 (with
    the box smoother of the main path too): a sample that floors to the
    neighbouring cell in one of them takes the other one-sided derivative,
    and Adam's normalised steps carry the difference on.  So: TRE to 0.05
    voxels (measured 0.016, mean 0.0049), SDlogJ to 1e-3 (measured 1.6e-4);
    the winners may be different variants, their TRE within 0.05 voxels,
    both below the initial TRE."""
    _, _, t2, j2, tre0 = sweeps
    assert t2.dice.shape == (16, 2) and t2.rank.shape == (16,)
    np.testing.assert_allclose(t2.dice, j2.dice, rtol=0, atol=0.05)
    np.testing.assert_allclose(t2.jstd, j2.jstd, rtol=0, atol=1e-3)
    assert abs(t2.dice[t2.best, 0] - j2.dice[j2.best, 0]) < 0.05
    assert t2.dice[t2.best, 0] < tre0


def test_paired_entries_default_to_cuda(monkeypatch):
    """Without ``device="cpu"`` the paired sweeps and the MIND field ask for
    the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vols, movs, kfs, kms = _case(n=12, kpts=(4,))
    for call in (
        lambda: tpair.run_stage1_paired_sweep(vols, movs, kfs, kms, _STAGE1[:1]),
        lambda: tpair.run_stage2_paired_sweep(vols, movs, kfs, kms, _STAGE1[0], _STAGE2),
        lambda: convex_field_mind(vols[0], movs[0], 1, 2, 3, 2),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
