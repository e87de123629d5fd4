"""The port's host geometry (``convexadam_torch/geometry``), the warp
application, the translation helpers and ``validate_volume`` against the
JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  The
geometry modules are numpy and scipy in both packages, so every comparison
there is exact (tolerance 0).  Files are compared by their decompressed
payloads and parsed headers: ``gzip.compress`` stamps the time into its
header, so two ``.nii.gz`` files of the same image differ in their bytes.
"""

import gzip
import struct
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convexadam_torch.geometry as tgeo
import convexadam_torch.geometry.io as tio
import convexadam_tpu.geometry as jgeo
import convexadam_tpu.geometry.io as jio
import convexadam_tpu.geometry.resample as jresample
from convexadam_torch.geometry.image import MedicalImage as TImage
from convexadam_torch.pipeline import apply as tapply
from convexadam_torch.pipeline import translation as ttrans
from convexadam_torch.pipeline.convex_adam import validate_volume as t_validate
from convexadam_tpu.geometry.image import MedicalImage as JImage
from convexadam_tpu.pipeline import apply as japply
from convexadam_tpu.pipeline import translation as jtrans
from convexadam_tpu.pipeline.convex_adam import validate_volume as j_validate

torch.set_num_threads(2)

# a proper rotation (about z by 30 degrees, then x by 20) as a direction
_C, _S = np.cos(np.pi / 6), np.sin(np.pi / 6)
_CX, _SX = np.cos(np.pi / 9), np.sin(np.pi / 9)
_ROT = (np.array([[1, 0, 0], [0, _CX, -_SX], [0, _SX, _CX]])
        @ np.array([[_C, -_S, 0], [_S, _C, 0], [0, 0, 1]]))


def _meta(rng, rotated=True):
    spacing = tuple(rng.uniform(0.5, 2.5, 3))
    origin = tuple(rng.uniform(-50, 50, 3))
    direction = tuple(_ROT.ravel()) if rotated else (1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0)
    return spacing, origin, direction


def _pair_images(rng, shape=(9, 10, 11), dtype=np.float32, channels=None, rotated=True):
    full = shape + ((channels,) if channels else ())
    data = (rng.standard_normal(full) * 100).astype(dtype)
    meta = _meta(rng, rotated)
    return TImage(data, *meta), JImage(data, *meta)


def _same_image(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype
    assert a.spacing == b.spacing and a.origin == b.origin and a.direction == b.direction


def _payload(path):
    raw = path.read_bytes()
    return gzip.decompress(raw) if path.name.endswith(".gz") else raw


# ---------------------------------------------------------------------------
# file I/O
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["img.nii.gz", "img.nii", "img.mha"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8, np.float64])
def test_round_trip(rng, tmp_path, name, dtype):
    """The port's writer and reader give back the image and its dtype
    exactly, and its metadata to what the format keeps: NIfTI stores it in
    float32, MetaImage in 6 significant digits (``%g``), so on origins of
    up to 50 mm the tolerance is 1e-4 mm."""
    img, _ = _pair_images(rng, dtype=dtype)
    tio.write_image(img, tmp_path / name)
    back = tio.read_image(tmp_path / name)
    np.testing.assert_array_equal(back.data, img.data)
    assert back.data.dtype == np.dtype(dtype)
    np.testing.assert_allclose(back.affine, img.affine, atol=1e-4, rtol=0)


def test_vector_field_round_trip(rng, tmp_path):
    """A (z, y, x, 3) displacement field, as the CLIs write it, in NIfTI
    and MHA."""
    img, _ = _pair_images(rng, channels=3)
    for name in ("field.nii.gz", "field.mha"):
        tio.write_image(img, tmp_path / name)
        back = tio.read_image(tmp_path / name)
        np.testing.assert_array_equal(back.data, img.data)


@pytest.mark.parametrize("name", ["x.nii.gz", "x.nii", "x.mha"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_cross_read(rng, tmp_path, name, writer):
    """A file written by one package reads back equal in the other (arrays
    and metadata exact), and both packages write the same payload."""
    timg, jimg = _pair_images(rng, channels=3 if name.endswith("gz") else None)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tio.write_image(timg, tmp_path / "t" / name)
    jio.write_image(jimg, tmp_path / "j" / name)
    assert _payload(tmp_path / "t" / name) == _payload(tmp_path / "j" / name)
    src = tmp_path / ("t" if writer == "torch" else "j") / name
    _same_image(tio.read_image(src), jio.read_image(src))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_nib_order_cross(rng, tmp_path, dtype):
    """``save_volume_nib_order`` / ``load_volume_nib_order``, as the CLIs
    and the task driver use them: the same payload from both packages, and
    each reads the other's file to equal data and RAS affine."""
    data = (rng.standard_normal((7, 8, 9, 3)) * 10).astype(dtype)
    affine = np.eye(4)
    affine[:3, :3] = _ROT @ np.diag([0.8, 1.2, 2.0])
    affine[:3, 3] = (-3.0, 4.5, 10.0)
    tio.save_volume_nib_order(data, affine, tmp_path / "t.nii.gz")
    jio.save_volume_nib_order(data, affine, tmp_path / "j.nii.gz")
    assert _payload(tmp_path / "t.nii.gz") == _payload(tmp_path / "j.nii.gz")
    for src in ("t.nii.gz", "j.nii.gz"):
        td, ta = tio.load_volume_nib_order(tmp_path / src)
        jd, ja = jio.load_volume_nib_order(tmp_path / src)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(td, data.astype(np.float64))


@pytest.mark.parametrize("slope,inter", [(0.0, 100.0), (float("nan"), 5.0), (2.0, 100.0)])
def test_scl_slope_as_the_jax_package(rng, tmp_path, slope, inter):
    """``scl_slope`` 0 or NaN means no scaling, a real one is applied: the
    same array from both readers."""
    data = rng.standard_normal((5, 6, 7)).astype(np.float32)
    p = tmp_path / "raw.nii"
    tio.save_volume_nib_order(data, np.eye(4), p)
    blob = bytearray(p.read_bytes())
    struct.pack_into("<f", blob, 112, slope)
    struct.pack_into("<f", blob, 116, inter)
    p.write_bytes(bytes(blob))
    td, _ = tio.load_volume_nib_order(p)
    jd, _ = jio.load_volume_nib_order(p)
    np.testing.assert_array_equal(td, jd)
    want = data * 2.0 + 100.0 if slope == 2.0 else data
    np.testing.assert_allclose(td, want, rtol=1e-6)


@pytest.mark.parametrize("qfac", [1.0, -1.0])
def test_qform_quaternion_as_the_jax_package(tmp_path, qfac):
    """A header with only a qform (quaternion, qfac +-1, offsets): both
    readers give the same affine and image metadata."""
    data = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
    p = tmp_path / "q.nii"
    tio.save_volume_nib_order(data, np.eye(4), p)
    blob = bytearray(p.read_bytes())
    struct.pack_into("<h", blob, 254, 0)  # no sform
    struct.pack_into("<h", blob, 252, 1)  # qform
    struct.pack_into("<f", blob, 76, qfac)
    struct.pack_into("<3f", blob, 80, 0.7, 1.1, 2.3)  # pixdim[1:4]
    struct.pack_into("<3f", blob, 256, 0.1, -0.2, 0.3)  # quatern b, c, d
    struct.pack_into("<3f", blob, 268, 12.0, -7.5, 3.25)  # qoffset x, y, z
    p.write_bytes(bytes(blob))
    td, ta = tio.load_volume_nib_order(p)
    jd, ja = jio.load_volume_nib_order(p)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(td, jd)
    _same_image(tio.read_image(p), jio.read_image(p))


def test_mha_2d_as_the_jax_package(tmp_path):
    """A 2-D MetaImage becomes one slice, its 2x2 matrix embedded, in both
    packages."""
    hdr = (
        "ObjectType = Image\nNDims = 2\nDimSize = 4 3\n"
        "ElementType = MET_FLOAT\nTransformMatrix = 0 -1 1 0\n"
        "Offset = 5 6\nElementSpacing = 2 3\nElementDataFile = LOCAL\n"
    )
    p = tmp_path / "slice2d.mha"
    p.write_bytes(hdr.encode() + np.arange(12, dtype=np.float32).tobytes())
    t, j = tio.read_image(p), jio.read_image(p)
    _same_image(t, j)
    assert t.data.shape == (1, 3, 4)


def test_unsupported_format_raises(tmp_path):
    img, _ = _pair_images(np.random.default_rng(0))
    with pytest.raises(ValueError, match="unsupported"):
        tio.write_image(img, tmp_path / "x.png")


# ---------------------------------------------------------------------------
# MedicalImage, resampling, displacement fields, translation helpers
# ---------------------------------------------------------------------------


def test_medical_image_methods_equal(rng):
    timg, jimg = _pair_images(rng)
    idx = rng.uniform(0, 9, (20, 3))
    np.testing.assert_array_equal(timg.affine, jimg.affine)
    np.testing.assert_array_equal(timg.index_to_world(idx), jimg.index_to_world(idx))
    w = timg.index_to_world(idx)
    np.testing.assert_array_equal(timg.world_to_index(w), jimg.world_to_index(w))
    assert timg.size == jimg.size
    other_t, other_j = _pair_images(rng)
    timg.copy_information(other_t)
    jimg.copy_information(other_j)
    _same_image(timg.astype(np.float64), jimg.astype(np.float64))


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.7, 1.3, 2.0)])
def test_resample_img_bit_for_bit(rng, spacing):
    timg, jimg = _pair_images(rng, shape=(12, 10, 14))
    _same_image(tgeo.resample_img(timg, spacing), jgeo.resample_img(jimg, spacing))


def test_resample_moving_to_fixed_bit_for_bit(rng):
    tf, jf = _pair_images(rng, shape=(10, 11, 12))
    tm, jm = _pair_images(rng, shape=(13, 9, 8), rotated=False)
    _same_image(tgeo.resample_moving_to_fixed(tf, tm), jgeo.resample_moving_to_fixed(jf, jm))
    _same_image(tgeo.resample_to_reference(tm, tf, order=0),
                jresample.resample_to_reference(jm, jf, order=0))


def test_rescale_displacement_field_bit_for_bit(rng):
    """Rotated fixed and moving directions, anisotropic spacings."""
    tf, jf = _pair_images(rng, shape=(10, 11, 12))
    tm, jm = _pair_images(rng, shape=(9, 12, 10), rotated=False)
    tr, jr = tgeo.resample_img(tf, (1.0, 1.0, 1.0)), jgeo.resample_img(jf, (1.0, 1.0, 1.0))
    field = rng.standard_normal(tr.data.shape + (3,)).astype(np.float32)
    out_t = tgeo.rescale_displacement_field(field, tm, tf, tr)
    out_j = jgeo.rescale_displacement_field(field, jm, jf, jr)
    np.testing.assert_array_equal(out_t, out_j)


def test_translation_helpers_bit_for_bit(rng):
    timg, jimg = _pair_images(rng)
    t = tuple(rng.uniform(-10, 10, 3))
    np.testing.assert_array_equal(
        ttrans.index_translation_to_world_translation(t, timg.direction),
        jtrans.index_translation_to_world_translation(t, jimg.direction),
    )
    _same_image(ttrans.apply_translation(timg, t), jtrans.apply_translation(jimg, t))


# ---------------------------------------------------------------------------
# warp application
# ---------------------------------------------------------------------------


def test_apply_convex_matches_jax(rng):
    """The plain gather against the JAX ``map_coordinates_trilinear``: the
    corner weights multiply in another order, measured max |diff| 1.5e-5
    on values of about 100; bound 1e-4 (1e-6 relative)."""
    mov = (rng.standard_normal((14, 12, 10)) * 100).astype(np.float32)
    disp = rng.uniform(-3, 3, (14, 12, 10, 3)).astype(np.float32)
    out_t = tapply.apply_convex(disp, mov, device="cpu")
    out_j = japply.apply_convex(disp, mov)
    assert out_t.dtype == np.float32 and out_t.shape == mov.shape
    np.testing.assert_allclose(out_t, out_j, atol=1e-4, rtol=0)
    # MedicalImage inputs and tensors take the same path
    np.testing.assert_array_equal(
        tapply.apply_convex(TImage(disp), torch.from_numpy(mov), device="cpu"), out_t)


def test_apply_convex_original_moving_matches_jax(rng):
    tf, jf = _pair_images(rng, shape=(10, 11, 12))
    tm, jm = _pair_images(rng, shape=(9, 12, 10), rotated=False)
    tr, jr = tgeo.resample_img(tf, (1.0, 1.0, 1.0)), jgeo.resample_img(jf, (1.0, 1.0, 1.0))
    disp = rng.uniform(-2, 2, tr.data.shape + (3,)).astype(np.float32)
    out_t = tapply.apply_convex_original_moving(disp, tm, tf, tr, device="cpu")
    out_j = japply.apply_convex_original_moving(disp, jm, jf, jr)
    np.testing.assert_allclose(out_t.data, out_j.data, atol=1e-4, rtol=0)  # as above
    assert out_t.spacing == out_j.spacing and out_t.origin == out_j.origin


def test_apply_convex_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapply.apply_convex(np.zeros((4, 4, 4, 3), np.float32), z)


# ---------------------------------------------------------------------------
# validate_volume
# ---------------------------------------------------------------------------


class _NibLike:
    """A nibabel spatial image as far as ``validate_volume`` looks."""

    def __init__(self, arr):
        self._arr = arr

    def get_fdata(self):
        return self._arr.astype(np.float64)


def _sitk_like(arr):
    """An image of a SimpleITK-shaped module: the module defines
    ``GetArrayFromImage``, the image ``GetSpacing`` and friends."""
    mod = types.ModuleType("fake_sitk_for_port_tests")

    class Image:
        def __init__(self, a):
            self._a = a

        def GetSpacing(self):
            return (1.0, 2.0, 3.0)

        def GetOrigin(self):
            return (-5.0, 0.0, 5.0)

        def GetDirection(self):
            return (1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0)

    Image.__module__ = mod.__name__
    mod.Image = Image
    mod.GetArrayFromImage = lambda im: im._a
    sys.modules[mod.__name__] = mod
    return Image(arr)


_KINDS = {
    "numpy_f64": lambda a: a.astype(np.float64),
    "numpy_int16": lambda a: a.astype(np.int16),
    "torch": lambda a: torch.from_numpy(a.copy()),
    "torch_requires_grad": lambda a: torch.from_numpy(a.copy()).requires_grad_(True),
    "medical_image": lambda a: "MedicalImage",
    "nibabel": _NibLike,
    "sitk": _sitk_like,
    "jax_array": lambda a: jnp.asarray(a),
}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_validate_volume_matches_jax(kind):
    """Every input kind the JAX ``validate_volume`` takes gives the same
    float32 array in the port; a ``jax.Array`` comes in through
    ``__array__`` (the port imports no JAX)."""
    a = (np.random.default_rng(3).standard_normal((5, 6, 7)) * 50).astype(np.float32)
    make = _KINDS[kind]
    if kind == "medical_image":
        t_in, j_in = TImage(a), JImage(a)
    else:
        t_in = j_in = make(a)
    out_t, out_j = t_validate(t_in), j_validate(j_in)
    assert out_t.dtype == np.float32 and out_j.dtype == np.float32
    np.testing.assert_array_equal(out_t, out_j)


def test_validate_volume_rejects_what_jax_rejects():
    for bad in (object(), "a string", None):
        with pytest.raises(ValueError):
            j_validate(bad)
        with pytest.raises(ValueError):
            t_validate(bad)


def test_medical_image_from_sitk_duck_type():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    mi = TImage.from_sitk(_sitk_like(a))
    np.testing.assert_array_equal(mi.data, a)
    assert mi.spacing == (1.0, 2.0, 3.0) and mi.origin == (-5.0, 0.0, 5.0)
    with pytest.raises(TypeError, match="SimpleITK"):
        TImage.from_sitk(object())
