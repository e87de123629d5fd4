"""The port's SAD and masked cost volumes, candidate blocks, streamed convex
path and strided data term against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go to both packages; the plain
kernel versions (what a wrapper runs for CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels against on the card) stand in for
the kernels.  The tolerance of each assert is written beside it with the
value measured.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convexadam_tpu.core import adam as jadam
from convexadam_tpu.core import convex as jconvex
from convexadam_tpu.core import cost_volume as jcv
from convexadam_tpu.core import warp as jwarp
from convexadam_torch.core import adam as tadam
from convexadam_torch.core import convex as tconvex
from convexadam_torch.core import cost_volume as tcv
from convexadam_torch.kernels.cost_volume import (
    cost_volume,
    cost_volume_block,
    cost_volume_block_plain,
    cost_volume_plain,
)
from convexadam_torch.kernels.warp import sub_extent, warp_ssd_loss_grad, warp_ssd_loss_grad_plain

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(rng, shape=(6, 9, 10, 11)):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _one_hot_pair(rng, shape=(8, 10, 9), labels=3, shift=(1, -1, 0)):
    """One-hot features of a label volume and of its roll: exact ties."""
    lab = rng.integers(0, labels, shape)
    lab_m = np.roll(lab, shift, axis=(0, 1, 2))
    eye = np.eye(labels, dtype=np.float32)
    return (np.moveaxis(eye[lab], -1, 0).copy(), np.moveaxis(eye[lab_m], -1, 0).copy())


# ---------------------------------------------------------------------------
# SAD, candidate blocks, the masked volume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 2, 3])
def test_sad_cost_volume_matches_jax(rng, q):
    """``correlate(metric="sad")``: the raw volume equals the JAX scan's to
    the bit (measured 0: |x| is exact and C = 6 channels add in the same
    order), the smoothed one within 1e-5 (the box passes' order; measured
    2.4e-6 of values up to 7.9) and the argmin everywhere."""
    f, m = _pair(rng)
    raw = cost_volume_plain(_t(f), _t(m), q, "sad").numpy()
    j_raw, _ = jcv.correlate(jnp.asarray(f), jnp.asarray(m), q, metric="sad", smooth_passes=0)
    np.testing.assert_array_equal(raw, np.asarray(j_raw))
    js, ja = jcv.correlate(jnp.asarray(f), jnp.asarray(m), q, metric="sad")
    ts, ta = tcv.correlate(_t(f), _t(m), q, metric="sad")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("q,kh0,nkh", [(1, 0, 1), (2, 3, 2), (3, 6, 1), (3, 0, 7)])
def test_block_is_the_dense_volume_slab(rng, metric, q, kh0, nkh):
    """A candidate block's plain version (and its wrapper on CPU tensors)
    equals the matching slab of the dense volume to the bit: index (kd*K +
    kw)*nkh + kh - kh0 of the block is kd*K^2 + kw*K + kh of the volume."""
    f, m = _pair(rng, (5, 7, 9, 6))
    K = 2 * q + 1
    dense = cost_volume_plain(_t(f), _t(m), q, metric).reshape(K, K, K, 7, 9, 6)
    block = cost_volume_block_plain(_t(f), _t(m), q, kh0, nkh, metric).reshape(K, K, nkh, 7, 9, 6)
    assert torch.equal(block, dense[:, :, kh0:kh0 + nkh])
    assert torch.equal(cost_volume_block(_t(f), _t(m), q, kh0, nkh, metric).reshape(block.shape),
                       block)
    assert torch.equal(cost_volume(_t(f), _t(m), q, metric).reshape(dense.shape), dense)


# task 1's half-width (pipeline/challenges.py: disp_hw 8), which the card runs
# through the general kernel, and q = 0; a ragged 3 x 8 x 8 x 10 crop keeps
# the JAX scan over K^3 = 4913 candidates to about a second
@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("q", [0, 8])
def test_cost_volume_plain_matches_jax_unsmoothed(rng, q, metric):
    """``cost_volume_plain`` against the JAX package's raw volume
    (``correlate(..., smooth_passes=0)``, the XLA scan on the CPU), rtol 1e-5:
    XLA may fuse the square into the channel sum (measured: SAD equal, SSD
    2.3e-7 relative)."""
    f, m = _pair(rng, (3, 8, 8, 10))
    j_raw, _ = jcv.correlate(jnp.asarray(f), jnp.asarray(m), q, metric=metric, smooth_passes=0)
    out = cost_volume_plain(_t(f), _t(m), q, metric).numpy()
    np.testing.assert_allclose(out, np.asarray(j_raw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("kh0,nkh", [(0, 1), (5, 4), (16, 1)])
def test_cost_volume_block_plain_matches_jax_at_q8(rng, metric, kh0, nkh):
    """``cost_volume_block_plain`` at q = 8 against the same kh of the JAX
    package's raw volume, rtol 1e-5 (the rounding, as above)."""
    q, K = 8, 17
    f, m = _pair(rng, (3, 8, 8, 10))
    j_raw, _ = jcv.correlate(jnp.asarray(f), jnp.asarray(m), q, metric=metric, smooth_passes=0)
    ref = np.asarray(j_raw).reshape(K, K, K, 8, 8, 10)[:, :, kh0:kh0 + nkh]
    out = cost_volume_block_plain(_t(f), _t(m), q, kh0, nkh, metric).numpy()
    np.testing.assert_allclose(out.reshape(ref.shape), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q", [1, 2])
def test_correlate_masked_matches_jax(rng, q):
    """``ssd *= mask`` then the argmin: the values within 1e-5 (measured
    4.8e-6, the box passes' order), the argmin everywhere, masked-out
    voxels at 0 and their argmin the first candidate."""
    f, m = _pair(rng)
    mask = rng.random((9, 10, 11)) > 0.4
    js, ja = jcv.correlate_masked(jnp.asarray(f), jnp.asarray(m), jnp.asarray(mask), q)
    ts, ta = tcv.correlate_masked(_t(f), _t(m), _t(mask), q)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert float(ts[:, ~_t(mask)].abs().max()) == 0.0 and int(ta[~_t(mask)].max()) == 0


def test_cost_volume_rejects_unknown_metric(rng):
    f, m = _pair(rng, (2, 4, 4, 4))
    with pytest.raises(ValueError, match="metric"):
        tcv.correlate(_t(f), _t(m), 1, metric="ncc")


# ---------------------------------------------------------------------------
# the streamed convex path and the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("q,passes", [(1, 2), (2, 1), (3, 2)])
def test_streamed_equals_dense_bit_for_bit(rng, metric, q, passes):
    """The streamed path's field equals the dense path's to the bit, on
    random features and on one-hot features full of exact ties (where only
    the first-minimum rule decides)."""
    for f, m in (_pair(rng), _one_hot_pair(rng)):
        dense = tconvex.convex_displacement(_t(f), _t(m), q, metric=metric, smooth_passes=passes)
        streamed = tconvex.correlate_coupled_streamed(_t(f), _t(m), q, metric=metric,
                                                      smooth_passes=passes)
        assert torch.equal(streamed, dense)


@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("q", [1, 2, 3])
def test_streamed_matches_jax_streamed(rng, metric, q):
    """Against ``correlate_coupled_streamed`` on the same features: the
    argmins agree, so the fields differ only by the box passes' rounding
    (measured at most 2.4e-7 voxels), bound 1e-6."""
    f, m = _pair(rng)
    ref = np.asarray(jconvex.correlate_coupled_streamed(jnp.asarray(f), jnp.asarray(m), q,
                                                        metric=metric))
    out = tconvex.correlate_coupled_streamed(_t(f), _t(m), q, metric=metric).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_dispatch_streams_above_the_threshold(rng, monkeypatch):
    """``convex_displacement`` takes the streamed path exactly when the
    dense estimate exceeds ``stream_threshold``: the K^3 n float32 volume
    and the larger of a temporary of its size and the coupled argmin's two
    (3, K^3, n) temporaries (n voxels, one chunk here); the default
    threshold is the one derived for the 80 GB card."""
    f, m = _pair(rng, (4, 6, 5, 7))
    q = 2
    est = tconvex.dense_estimate(q, (6, 5, 7))
    assert est == 125 * 210 * 4 + 2 * 3 * 125 * 210 * 4
    assert tconvex.COST_VOLUME_STREAM_THRESHOLD == 64_000_000_000
    calls = []
    real = tconvex.correlate_coupled_streamed

    def spy(*args, **kwargs):
        calls.append(kwargs.get("metric"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tconvex, "correlate_coupled_streamed", spy)
    at = tconvex.convex_displacement(_t(f), _t(m), q, metric="sad", stream_threshold=est)
    assert calls == []
    above = tconvex.convex_displacement(_t(f), _t(m), q, metric="sad", stream_threshold=est - 1)
    assert calls == ["sad"]
    assert torch.equal(at, above)
    # the (grid_sp 2, disp_hw 7) class at 192 x 160 x 256 runs dense; at
    # 256 x 256 x 320 it streams
    assert tconvex.dense_estimate(7, (96, 80, 128)) <= tconvex.COST_VOLUME_STREAM_THRESHOLD
    assert tconvex.dense_estimate(7, (128, 128, 160)) > tconvex.COST_VOLUME_STREAM_THRESHOLD


# ---------------------------------------------------------------------------
# the strided data term and Adam's sample_stride
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,stride", [((16, 16, 16), 2), ((15, 15, 16), 2), ((22, 24, 24), 3)])
def test_strided_data_term_matches_pallas(rng, shape, stride):
    """The strided data term's plain version against
    ``warp_ssd_loss_and_grad(..., interpret=True, stride=s)`` (the Pallas
    kernel in interpret mode on the sub-lattice), on a grid that s divides
    and on ones it does not: the loss within 1e-6 relative (measured 2e-7)
    and the gradient within 5e-7 of its largest entry (measured 1.5e-7)."""
    C = 4
    H, W, D = shape
    sub = tuple(sub_extent(s, stride) for s in shape)
    n = sub[0] * sub[1] * sub[2]
    mov = rng.standard_normal((C, H, W, D)).astype(np.float32)
    fix = rng.standard_normal((C, n)).astype(np.float32)
    disp = (rng.standard_normal((3, *sub)) * 1.5).astype(np.float32)
    loss, ddisp = jwarp.warp_ssd_loss_and_grad(
        jwarp.build_corner_stack(jnp.asarray(mov)), (C, H, W, D), jnp.asarray(disp),
        jnp.asarray(fix), 12.0, interpret=True, stride=stride,
    )
    fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
    chain = 2.0 * 12.0 / (C * n)
    ssq, rows = warp_ssd_loss_grad_plain(_t(mov), _t(disp), _t(fix), fac, chain, stride)
    ddisp = np.asarray(ddisp)
    out = (rows * torch.tensor(fac).reshape(3, 1).float()).numpy().reshape(ddisp.shape)
    np.testing.assert_allclose(float(ssq) * (12.0 / (C * n)), float(loss), rtol=1e-6)
    np.testing.assert_allclose(out, ddisp, rtol=0, atol=5e-7 * np.abs(ddisp).max())
    # the wrapper takes the plain version for CPU tensors
    ssq_w, rows_w = warp_ssd_loss_grad(_t(mov), _t(disp), _t(fix), fac, chain, stride)
    assert torch.equal(rows_w, rows) and torch.equal(ssq_w, ssq)


@pytest.mark.parametrize("stride", [2, 3])
def test_adam_sample_stride_matches_jax(rng, stride):
    """Ten iterations with the data term on the (::s)^3 sub-lattice, from an
    init with no exactly-zero component (ROADMAP, one-sided derivatives at
    zero): measured max |diff| 2.8e-5 (s = 2) and 4.5e-5 (s = 3), bound
    1e-4, as the stride-1 test."""
    C, h, w, d = 4, 9, 8, 7
    fix = rng.standard_normal((C, h, w, d)).astype(np.float32)
    mov = rng.standard_normal((C, h, w, d)).astype(np.float32)
    init = (rng.standard_normal((3, h, w, d)) * 0.5).astype(np.float32)
    ref, ref_snaps = jadam.adam_instance_optimisation(
        jnp.asarray(fix), jnp.asarray(mov), jnp.asarray(init), 1.25, 10, snapshot_iters=(4,),
        sample_stride=stride,
    )
    out, snaps = tadam.adam_instance_optimisation(
        _t(fix), _t(mov), _t(init), 1.25, 10, snapshot_iters=(4,), sample_stride=stride
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(ref_snaps), rtol=0, atol=1e-4)
    dense, _ = tadam.adam_instance_optimisation(_t(fix), _t(mov), _t(init), 1.25, 10)
    assert not torch.equal(out, dense)
