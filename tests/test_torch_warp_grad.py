"""The port's differentiable trilinear warp against the JAX package on the CPU.

* ``sample_trilinear_bwd_plain`` (what the wrapper runs for CPU tensors and
  what ``chip_smoke.py`` holds the CUDA kernel against) against the Pallas
  kernel it replaces, ``corner_reduce_bwd``, in interpret mode;
* the differentiable warp's gradients against ``jax.grad`` of the JAX
  package's stacked warp and against ``F.grid_sample``'s;
* ``grid_sample_3d``'s gradients against the JAX package's custom VJP;
* the unfused Adam data term against the fused one, and one autodiff Adam
  gradient step against the JAX package's;
* ``compose_displacements`` and ``map_coordinates_trilinear``.

Inputs are made from a seed with numpy and handed to both packages; every
tolerance is stated beside its assert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from convexadam_tpu.core import adam as jadam
from convexadam_tpu.core import warp as jwarp
from convexadam_tpu.ops.warp_pallas import corner_reduce_bwd
from convexadam_torch.core import adam as tadam
from convexadam_torch.core import warp as twarp
from convexadam_torch.kernels import LAUNCHES, reset_launches
from convexadam_torch.kernels.warp import sample_trilinear_bwd, sample_trilinear_bwd_plain
from test_torch_kernels import _pallas_block

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_trilinear_bwd_matches_corner_reduce_bwd(rng, dtype):
    C, H, W, D, n = 3, 6, 7, 8, 512
    scale = 1.7
    vol = rng.standard_normal((C, H, W, D)).astype(np.float32)
    if dtype == "bfloat16":
        vol = torch.from_numpy(vol).to(torch.bfloat16).float().numpy()
    # normalized coordinates reaching past the volume on every side
    grid = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    ct = rng.standard_normal((C, n)).astype(np.float32)
    pos = np.stack([((grid[:, a] + np.float32(1)) * np.float32(s) - np.float32(1))
                    * np.float32(0.5) for a, s in enumerate((H, W, D))])
    p0 = np.floor(pos)
    block = _pallas_block(vol, pos)
    if dtype == "bfloat16":
        block = block.astype(jnp.bfloat16)
    ref = np.asarray(corner_reduce_bwd(
        block, jnp.asarray(ct), tuple(jnp.asarray(f) for f in (pos - p0)),
        tuple(jnp.asarray(b) for b in p0.astype(np.int32)), (C, H, W, D), scale,
        interpret=True,
    ))
    vol_t = _t(vol).to(getattr(torch, dtype))[None]
    out = sample_trilinear_bwd(vol_t, _t(grid)[None], _t(ct)[None], scale)[0]
    np.testing.assert_array_equal(
        out.numpy(), sample_trilinear_bwd_plain(vol_t, _t(grid)[None], _t(ct)[None], scale)[0]
    )
    # the Pallas kernel's order, channels then corners; only its jnp.sum over
    # the channels may associate differently: 1e-6 relative to the largest
    # row entry
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def _bwd_rows_corners_first(vol, grid, ct, scale):
    """The coordinate-gradient rows in the order of the first backward
    kernel: per channel the three derivatives from the 8 corners, then the
    channels weighted by ``ct * scale``."""
    B, C = vol.shape[:2]
    flat = vol.reshape(B, C, -1)
    sx = sy = sz = None
    for lin, _, gx, gy, gz in twarp._grid_corners(vol, grid, grads=True):
        v = torch.gather(flat, 2, lin[:, None, :].expand(B, C, lin.shape[1])).float()
        tx, ty, tz = v * gx[:, None, :], v * gy[:, None, :], v * gz[:, None, :]
        if sx is None:
            sx, sy, sz = tx, ty, tz
        else:
            sx, sy, sz = sx + tx, sy + ty, sz + tz
    cs = ct * scale
    return torch.stack([(cs * s).sum(1) for s in (sx, sy, sz)], dim=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_trilinear_bwd_plain_matches_corners_first_order(rng, dtype):
    """Reordering the sums (channels first) moves the rows by rounding
    only."""
    B, C, H, W, D, n = 2, 5, 9, 7, 8, 700
    vol = _t(rng.standard_normal((B, C, H, W, D)).astype(np.float32)).to(getattr(torch, dtype))
    grid = _t(rng.uniform(-1.3, 1.3, (B, n, 3)).astype(np.float32))
    ct = _t(rng.standard_normal((B, C, n)).astype(np.float32))
    out = sample_trilinear_bwd_plain(vol, grid, ct, 0.37).numpy()
    old = _bwd_rows_corners_first(vol, grid, ct, 0.37).numpy()
    # float32 sums of a few terms in another association: 1e-6 relative L2
    assert _rel_l2(out, old) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_warp_value_and_disp_grad_match_jax(rng, dtype):
    """The ``tests/test_warp.py`` stacked-sampler case: value and
    ``jax.grad`` of ``sum(warp ** 2)`` in the displacement."""
    C, H, W, D = 3, 7, 8, 6
    vol = rng.standard_normal((C, H, W, D)).astype(np.float32)
    if dtype == "bfloat16":
        vol = torch.from_numpy(vol).to(torch.bfloat16).float().numpy()
    disp = (rng.standard_normal((3, H, W, D)) * 3.0).astype(np.float32)
    # the JAX stack holds the same (bf16-representable) values in float32:
    # with a bf16 stack its backward recomputes the sample coordinates in
    # bf16 (_gs_stacked_bwd's compute dtype is the block's), 0.25 relative
    # L2 away from the gradient of its own float32-coordinate forward
    vol8 = jwarp.build_corner_stack(jnp.asarray(vol))
    ref = jwarp.warp_with_displacement_stacked(vol8, (C, H, W, D), jnp.asarray(disp))
    g_ref = jax.grad(
        lambda d: jnp.sum(jwarp.warp_with_displacement_stacked(vol8, (C, H, W, D), d) ** 2)
    )(jnp.asarray(disp))
    d_t = _t(disp).requires_grad_(True)
    out = twarp.warp_with_displacement_stacked(_t(vol).to(getattr(torch, dtype)), d_t)
    (out ** 2).sum().backward()
    # the same weights on both sides: 1e-5 on the value; the gradient sums
    # corners and channels in another order, 1e-4 of its largest entry
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(d_t.grad.numpy(), g_ref, rtol=1e-4, atol=1e-4 * np.abs(g_ref).max())


def test_stacked_warp_vol_grad_matches_grid_sample(rng):
    """The volume cotangent (the plain scatter-add) against
    ``F.grid_sample``'s, on the same grid and cotangent."""
    C, H, W, D = 2, 6, 7, 5
    vol = rng.standard_normal((C, H, W, D)).astype(np.float32)
    disp = (rng.standard_normal((3, H, W, D)) * 2.0).astype(np.float32)
    ct = rng.standard_normal((C, H, W, D)).astype(np.float32)
    v_t = _t(vol).requires_grad_(True)
    (twarp.warp_with_displacement_stacked(v_t, _t(disp)) * _t(ct)).sum().backward()
    v_ref = _t(vol).requires_grad_(True)
    grid = twarp._displaced_grid((H, W, D), _t(disp), False)
    out = F.grid_sample(v_ref[None], grid.flip(-1)[None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    (out[0] * _t(ct)).sum().backward()
    # same corner weights, accumulated in another order: 1e-5
    np.testing.assert_allclose(v_t.grad.numpy(), v_ref.grad.numpy(), rtol=0, atol=1e-5)


def test_differentiable_sampler_counts_no_launch_on_cpu(rng):
    """Forward and backward on CPU tensors take the plain versions."""
    reset_launches()
    vol = _t(rng.standard_normal((2, 5, 5, 5)).astype(np.float32)).requires_grad_(True)
    d = torch.zeros((3, 5, 5, 5), requires_grad=True)
    twarp.warp_with_displacement_stacked(vol, d + 0.3).sum().backward()
    assert vol.grad is not None and d.grad is not None
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_grads_match_jax(rng, padding_mode, align_corners):
    """``grid_sample_3d``'s bilinear branch is ``F.grid_sample``: its vol and
    grid gradients against the JAX package's custom VJP."""
    C, H, W, D, n = 2, 6, 7, 5, 300
    vol = rng.standard_normal((C, H, W, D)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    ct = rng.standard_normal((C, n)).astype(np.float32)

    def jloss(v, g):
        return jnp.sum(jwarp.grid_sample_3d(v, g, align_corners, padding_mode) * ct)

    jv, jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(grid))
    v_t = _t(vol).requires_grad_(True)
    g_t = _t(grid).requires_grad_(True)
    (twarp.grid_sample_3d(v_t, g_t, align_corners, padding_mode) * _t(ct)).sum().backward()
    # the same derivative, accumulated in another order: 1e-4 of the largest
    # entry (the JAX grid gradient drops the clip's derivative on the border
    # exactly where torch's does)
    jv, jg = np.asarray(jv), np.asarray(jg)
    np.testing.assert_allclose(v_t.grad.numpy(), jv, rtol=1e-5, atol=1e-5 * np.abs(jv).max())
    np.testing.assert_allclose(g_t.grad.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_data_term_matches_fused(rng, dtype):
    """On a non-zero field the unfused data term (differentiable warp) and
    the fused one give the same value and displacement gradient."""
    C, H, W, D = 4, 7, 8, 6
    mov = _t(rng.standard_normal((C, H, W, D)).astype(np.float32)).to(getattr(torch, dtype))
    fix = _t(rng.standard_normal((C, H * W * D)).astype(np.float32))
    disp = rng.standard_normal((3, H, W, D)).astype(np.float32) * 1.5 + 0.25
    vals, grads = [], []
    for loss_fn in (twarp.warp_ssd_mean_loss, twarp.warp_ssd_mean_loss_unfused):
        d = _t(disp).requires_grad_(True)
        v = loss_fn(mov, d, fix, 12.0)
        v.backward()
        vals.append(float(v.detach()))
        grads.append(d.grad.numpy())
    # sample positions composed as index + disp * size/(size-1) (fused) and
    # through the normalized grid (unfused): 1e-5 on the value, 1e-4
    # relative L2 on the gradient
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)
    assert _rel_l2(grads[1], grads[0]) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_step_autodiff_matches_jax(rng, dtype):
    C, h, w, d = 4, 8, 9, 7
    fix = rng.standard_normal((C, h, w, d)).astype(np.float32)
    mov = rng.standard_normal((C, h, w, d)).astype(np.float32)
    if dtype == "bfloat16":
        mov = torch.from_numpy(mov).to(torch.bfloat16).float().numpy()
    init = (rng.standard_normal((3, h, w, d)) * 0.5).astype(np.float32)
    smoother = ("box", 3, 3)
    # a float32 stack of the same values (see the stacked-warp test above)
    stack = jwarp.build_corner_stack(jnp.asarray(mov))
    ds_ref, g_ref = jadam._grad_step_autodiff(
        jnp.asarray(init), jnp.asarray(fix), stack, (C, h, w, d), 1.25,
        jadam.resolve_smoother(smoother), 12.0,
    )
    loss, ds, g = tadam._grad_step_autodiff(
        _t(init).requires_grad_(True), _t(fix).reshape(C, -1),
        _t(mov).to(getattr(torch, dtype)), 1.25, tadam.resolve_smoother(smoother), 12.0,
    )
    assert loss.ndim == 0 and np.isfinite(float(loss))
    # the smoothed field: separable box sums in the JAX order, 1e-6; the
    # gradient: sums in another order, 1e-4 relative L2
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_ref), rtol=0, atol=1e-6)
    assert _rel_l2(g.numpy(), np.asarray(g_ref)) < 1e-4


def test_adam_loop_autodiff_tracks_fused(rng):
    """Ten Adam iterations with each gradient step from the same non-zero
    init: the two data terms differ in ulps, which Adam's normalised steps
    amplify only slightly (bound 1e-3 voxels)."""
    C, h, w, d = 4, 8, 9, 7
    fix = _t(rng.standard_normal((C, h * w * d)).astype(np.float32))
    mov = _t(rng.standard_normal((C, h, w, d)).astype(np.float32))
    init = _t((rng.standard_normal((3, h, w, d)) * 0.5 + 0.1).astype(np.float32))
    sm = tadam.resolve_smoother(("box", 3, 3))
    out = []
    for step in (tadam._grad_step_fused, tadam._grad_step_autodiff):
        final, snaps = tadam._adam_loop(
            lambda w, step=step: step(w, fix, mov, 1.25, sm, 12.0), init, 10, (5,)
        )
        out.append((final.numpy(), snaps.numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0, atol=1e-3)


@pytest.mark.parametrize("align_corners", [False, True])
def test_compose_displacements_matches_jax(rng, align_corners):
    d1 = (rng.standard_normal((3, 6, 7, 5)) * 0.2).astype(np.float32)
    d2 = (rng.standard_normal((3, 6, 7, 5)) * 0.2).astype(np.float32)
    ref = np.asarray(jwarp.compose_displacements(jnp.asarray(d1), jnp.asarray(d2), align_corners))
    out = twarp.compose_displacements(_t(d1), _t(d2), align_corners).numpy()
    # F.grid_sample against the JAX sampler: 1e-6
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["constant", "nearest"])
def test_map_coordinates_trilinear_matches_jax(rng, mode):
    vol = rng.standard_normal((6, 7, 5)).astype(np.float32)
    coords = rng.uniform(-1.5, 8.0, (3, 4, 9, 2)).astype(np.float32)
    ref = np.asarray(jwarp.map_coordinates_trilinear(jnp.asarray(vol), jnp.asarray(coords), mode))
    out = twarp.map_coordinates_trilinear(_t(vol), _t(coords), mode).numpy()
    assert out.shape == (4, 9, 2)
    # the same weights and corner order: 1e-6
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unsupported mode"):
        twarp.map_coordinates_trilinear(_t(vol), _t(coords), "wrap")
