"""End-to-end parity of the port's MIND registration on the CPU.

* against ``convex_adam_jax`` on one small case, the Adam stage started from
  the exact numpy init the JAX stage received;
* against the stored golden field ``golden_disp_48.npz`` (the envelopes of
  tests/test_pipeline.py);
* against the unmodified reference's field in ``reference_deformable_64.npz``
  (the envelope of tests/test_reference_parity.py).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convexadam_tpu.pipeline import convex_adam as jpipe
from convexadam_torch.convert import config_from_fields, tensor_from_numpy
from convexadam_torch.pipeline import convex_adam as tpipe

torch.set_num_threads(2)

_HERE = pathlib.Path(__file__).parent


def _volume(shape, seed):
    """Smooth random blobs, as tests/test_pipeline.py makes them."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))[None, None]
    for _ in range(2):
        t = F.avg_pool3d(t, 3, stride=1, padding=1)
    vol = t[0, 0].numpy()
    return (vol - vol.mean()) / vol.std() * 100.0


@pytest.mark.parametrize("ic", [True, False])
def test_convex_adam_matches_jax(ic):
    vol = _volume((32, 32, 32), 1)
    mov = np.roll(vol, (2, -1, 1), axis=(0, 1, 2))
    jcfg = jpipe.ConvexAdamConfig(grid_sp=4, disp_hw=2, selected_niter=20, ic=ic)
    ref = np.asarray(jpipe.convex_adam(vol, mov, jcfg))
    out = tpipe.convex_adam(vol, mov, config_from_fields(dataclasses.asdict(jcfg)), device="cpu")
    assert out.shape == ref.shape and out.dtype == np.float32
    # 20 Adam steps amplify ulp-level gradient differences in a few voxels
    # (measured max 0.006 voxels with ic=True); the field agrees to 1e-3 on
    # average and nowhere differs by more than 0.05 voxels
    err = np.abs(out - ref)
    assert err.max() < 0.05, err.max()
    assert err.mean() < 1e-3, err.mean()


def test_adam_stage_from_jax_init():
    """The port's Adam stage, started from the numpy init the JAX stage
    received, carried across with ``convert``.  (A shift the convex stage
    sees: from an all-zero init every sample lies on a voxel, where the two
    packages' differently composed positions may floor to neighbouring
    cells and pick the other one-sided derivative.)"""
    from convexadam_tpu.core.features import mindssc as jmind

    vol = _volume((24, 24, 24), 2)
    mov = np.roll(vol, (4, -3, 2), axis=(0, 1, 2))
    jcfg = jpipe.ConvexAdamConfig(grid_sp=4, disp_hw=2, selected_niter=10, dtype="float32")
    ff = jmind(jnp.asarray(vol), 1, 2)
    fm = jmind(jnp.asarray(mov), 1, 2)
    init = jpipe._convex_stage(ff, fm, jcfg, (24, 24, 24), for_adam_init=True)
    assert float(jnp.abs(init).max()) > 1.0
    ref, _ = jpipe._adam_stage(ff, fm, init, jcfg)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    out, _ = tpipe._adam_stage(
        tensor_from_numpy(np.asarray(ff), "cpu"), tensor_from_numpy(np.asarray(fm), "cpu"),
        tensor_from_numpy(np.asarray(init), "cpu"), cfg,
    )
    # ten Adam steps from one init: 1e-3 voxels
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def _golden_case():
    golden = np.load(_HERE / "golden_disp_48.npz")
    vol = golden["vol"].astype(np.float32)
    mov = np.roll(vol, tuple(golden["shift"]), axis=(0, 1, 2))
    return vol, mov, golden["disp"].astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_golden_envelope(dtype):
    """The golden field's envelopes: f32 median endpoint error < 0.05 and
    p99 < 0.5 voxels; bf16 median < 0.15, p99 < 0.75, max < 1.5."""
    vol, mov, ref = _golden_case()
    cfg = tpipe.ConvexAdamConfig(
        grid_sp=4, disp_hw=2, lambda_weight=1.25, selected_niter=80, grid_sp_adam=2, dtype=dtype
    )
    disp = tpipe.convex_adam(vol, mov, cfg, device="cpu")
    err = np.sqrt(((disp - ref) ** 2).sum(-1))
    med, p99 = np.median(err), np.quantile(err, 0.99)
    if dtype == "float32":
        assert med < 0.05 and p99 < 0.5, (med, p99)
    else:
        assert med < 0.15 and p99 < 0.75 and err.max() < 1.5, (med, p99, err.max())


def test_deformable_reference_envelope():
    """The reference's recovered field on a known smooth deformation: p95 of
    the pointwise difference < 0.1 voxels, and ground-truth recovery no
    worse than the reference's + 0.02."""
    ref = np.load(_HERE / "reference_deformable_64.npz")
    cfg = tpipe.ConvexAdamConfig(
        mind_r=1, mind_d=2, lambda_weight=1.25, grid_sp=4, disp_hw=3, selected_niter=60,
        selected_smooth=0, grid_sp_adam=2, ic=True, dtype="float32",
    )
    ours = tpipe.convex_adam(ref["fixed"], ref["moving"], cfg, device="cpu")
    cross = np.sqrt(((ours - ref["disp_ref"]) ** 2).sum(-1))
    assert np.percentile(cross, 95) < 0.1, np.percentile(cross, 95)
    gt = ref["gt"]
    c = 8
    err_ours = np.sqrt(((ours - gt) ** 2).sum(-1))[c:-c, c:-c, c:-c].mean()
    err_ref = np.sqrt(((ref["disp_ref"] - gt) ** 2).sum(-1))[c:-c, c:-c, c:-c].mean()
    assert err_ours <= err_ref + 0.02, (err_ours, err_ref)


def test_selected_smooth_and_snapshots():
    """Even ``selected_smooth`` rounds up, and snapshot k equals a run of k
    iterations, on the full-resolution output."""
    vol = _volume((24, 24, 24), 4)
    mov = np.roll(vol, (1, 0, -1), axis=(0, 1, 2))
    f = tpipe.mindssc(torch.from_numpy(vol), 1, 2)
    m = tpipe.mindssc(torch.from_numpy(mov), 1, 2)
    base = tpipe.ConvexAdamConfig(grid_sp=4, disp_hw=2, selected_niter=6)
    init = tpipe._convex_stage(f, m, base, (24, 24, 24), for_adam_init=True)
    _, snaps = tpipe._adam_stage(f, m, init, dataclasses.replace(base, snapshot_iters=(3,)))
    three, _ = tpipe._adam_stage(f, m, init, dataclasses.replace(base, selected_niter=3))
    np.testing.assert_allclose(snaps[0].numpy(), three.numpy(), rtol=0, atol=1e-6)
    even, _ = tpipe._adam_stage(f, m, init, dataclasses.replace(base, selected_smooth=2))
    odd, _ = tpipe._adam_stage(f, m, init, dataclasses.replace(base, selected_smooth=3))
    np.testing.assert_array_equal(even.numpy(), odd.numpy())


def test_degenerate_grids_raise():
    z = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="grid_sp=6"):
        tpipe.convex_adam(z, z, device="cpu")
    with pytest.raises(ValueError, match="grid_sp_adam=6"):
        tpipe.convex_adam(z, z, device="cpu", grid_sp=2, disp_hw=1, grid_sp_adam=6)
