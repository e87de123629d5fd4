"""The port's host EDT (``convexadam_torch/native``, ``utils/edt.py``) and
its ``mask_infill`` against the JAX package, on the CPU.

The infill gathers the image at each outside voxel's nearest inside voxel.
Where several inside voxels are nearest, the JAX package's native EDT picks
one and scipy's ``distance_transform_edt`` may pick another, so the port
carries a copy of that native EDT and must equal it index for index; the
infill then equals the JAX package's bit for bit.  Masks with many ties
(boxes, random voxels at 50-99% inside) make every difference show.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

import convexadam_torch.native as tnative
from convexadam_torch.pipeline.preprocess import mask_infill as t_infill
from convexadam_torch.utils.edt import edt_distance, edt_nearest_indices
from convexadam_tpu.native import edt as jnative
from convexadam_tpu.pipeline.preprocess import mask_infill as j_infill

torch.set_num_threads(2)

_SHAPE = (23, 30, 17)


def _random_mask(frac, seed=0, shape=_SHAPE):
    return np.random.default_rng(seed).random(shape) < frac


@pytest.mark.parametrize("frac", [0.5, 0.9, 0.99])
def test_edt_indices_equal_the_jax_native_edt(frac):
    """Indices equal, distances equal (tolerance 0), on random masks."""
    m = _random_mask(frac)
    np.testing.assert_array_equal(edt_nearest_indices(m), jnative.nearest_indices(m))
    np.testing.assert_array_equal(edt_distance(m), jnative.distance(m))


@pytest.mark.parametrize("case", ["all_foreground", "all_background", "one_site", "box"])
def test_edt_edge_cases_equal_the_jax_native_edt(case):
    m = np.ones((9, 8, 7), bool)
    if case == "all_background":
        m[:] = False
    elif case == "one_site":
        m[4, 0, 6] = False
    elif case == "box":
        m[2:7, 1:6, 2:5] = False
    np.testing.assert_array_equal(edt_nearest_indices(m), jnative.nearest_indices(m))
    np.testing.assert_array_equal(edt_distance(m), jnative.distance(m))


@pytest.mark.parametrize("sampling", [(1.5, 1.0, 0.8), 2.0])
@pytest.mark.parametrize("frac", [0.5, 0.99])
def test_edt_distance_sampling_equals_jax(frac, sampling):
    """``edt_distance(mask, sampling=...)`` equals the JAX package's (scipy
    with the voxel spacing, tolerance 0, float64), and the call without
    ``sampling`` stays on the native EDT, float32, equal to the JAX
    package's native distances."""
    from convexadam_tpu.utils.edt import edt_distance as j_edt_distance

    m = _random_mask(frac, seed=3)
    got = edt_distance(m, sampling=sampling)
    want = j_edt_distance(m, sampling=sampling)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    plain = edt_distance(m)
    assert plain.dtype == np.float32
    np.testing.assert_array_equal(plain, jnative.distance(m))
    assert not np.allclose(got, plain)


@pytest.mark.parametrize("frac", [0.5, 0.9, 0.99])
def test_scipy_breaks_ties_otherwise(frac):
    """Why the port carries the native EDT: scipy's distances agree (to
    float32 rounding, 1e-5), its nearest indices do not, at hundreds to
    thousands of voxels of these masks."""
    m = _random_mask(frac)
    dist, idx = distance_transform_edt(m, return_indices=True)
    np.testing.assert_allclose(edt_distance(m), dist, atol=1e-5, rtol=0)
    assert (idx != edt_nearest_indices(m)).any(axis=0).sum() > 100


def _image(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 100).astype(np.float32)


def _box_mask(shape):
    m = np.zeros(shape, np.float32)
    H, W, D = shape
    m[H // 4: 3 * H // 4, W // 5: 4 * W // 5, 2: D - 3] = 1.0
    return m


@pytest.mark.parametrize("shape", [(24, 20, 16), (23, 19, 17), (22, 21, 15)])
@pytest.mark.parametrize("mask", ["box", "random_90", "random_50"])
def test_mask_infill_equals_jax_bit_for_bit(shape, mask):
    """Even and odd shapes (the JAX module's ceil(S/2) strides and its crop
    of the x2 upsample), a box mask and random masks full of ties;
    tolerance 0."""
    img = _image(shape, 1)
    m = _box_mask(shape) if mask == "box" else _random_mask(
        int(mask.split("_")[1]) / 100, seed=2, shape=shape).astype(np.float32)
    out_t = t_infill(img, m, device="cpu")
    out_j = j_infill(img, m)
    assert out_t.dtype == np.float32 and out_t.shape == shape
    np.testing.assert_array_equal(out_t, out_j)


def test_mask_infill_takes_tensors():
    img, m = _image((12, 10, 8), 4), _box_mask((12, 10, 8))
    out = t_infill(torch.from_numpy(img), torch.from_numpy(m), device="cpu")
    np.testing.assert_array_equal(out, j_infill(img, m))


def test_mask_infill_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_infill(z, z)


def test_native_edt_builds_into_build_keyed_by_hash():
    """The library goes to build/native at the checkout root, named by a
    hash of the source and the flags; the source is not touched."""
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("_edt_") and path.suffix == ".so" and path.exists()
    assert not (tnative._HERE / "_edt.so").exists()


def test_native_edt_build_failure_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's message; nothing falls
    back to scipy."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "GXX_FLAGS", ("-O3", "-shared", "-fPIC", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        tnative.build()


def test_edt_rejects_other_ranks():
    with pytest.raises(ValueError, match="3-D"):
        edt_nearest_indices(np.ones((4, 4), bool))
