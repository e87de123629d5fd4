"""Pure-numpy medical image I/O: NIfTI-1 (.nii/.nii.gz) and MetaImage (.mha/.mhd).

The reference relies on nibabel (convex_adam_MIND.py:225-226) and SimpleITK
(convex_adam_translation.py, tests) for file I/O; neither is assumed here —
both formats are implemented directly against their specifications.

Conventions: arrays are returned (z, y, x) with sitk-style (x, y, z)
spacing/origin/direction metadata; the world frame is LPS (NIfTI's RAS affine
is converted, matching how SimpleITK reads NIfTI files).
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from convexadam_torch.geometry.image import MedicalImage

# -- NIfTI-1 ------------------------------------------------------------------

_NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _quaternion_to_matrix(b, c, d, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ]
    )
    if qfac < 0:
        R[:, 2] *= -1
    return R


def _read_nifti(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Parse a NIfTI-1 blob → (data (i,j,k[,t...]) array, RAS affine)."""
    hdr = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        if struct.unpack(">i", hdr[0:4])[0] != 348:
            raise ValueError("not a NIfTI-1 file")

    def u(fmt, off, n=1):
        vals = struct.unpack_from(endian + fmt * n, hdr, off)
        return vals[0] if n == 1 else vals

    magic = hdr[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic: {magic!r}")

    dim = u("h", 40, 8)
    ndim = dim[0]
    shape = tuple(int(s) for s in dim[1 : 1 + ndim])
    datatype = u("h", 70)
    if datatype not in _NIFTI_DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)
    pixdim = u("f", 76, 8)
    vox_offset = int(u("f", 108))
    scl_slope = u("f", 112)
    scl_inter = u("f", 116)
    qform_code = u("h", 252)
    sform_code = u("h", 254)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    # NIfTI stores i fastest → C-order shape is reversed
    data = data.reshape(shape[::-1]).transpose(tuple(range(len(shape)))[::-1])

    # NIfTI-1 spec (and nibabel): scl_slope == 0 (or NaN) means NO scaling
    # at all — the intercept must NOT be applied (some tools emit
    # slope=0/inter!=0 for "unset")
    if (
        np.isfinite(scl_slope)
        and np.isfinite(scl_inter)
        and scl_slope != 0.0
        and (scl_slope != 1.0 or scl_inter != 0.0)
    ):
        data = data * scl_slope + scl_inter

    if sform_code > 0:
        srow = np.array(
            [u("f", 280, 4), u("f", 296, 4), u("f", 312, 4)], dtype=float
        )
        affine = np.vstack([srow, [0, 0, 0, 1]])
    elif qform_code > 0:
        b, c, d = u("f", 256), u("f", 260), u("f", 264)
        qx, qy, qz = u("f", 268), u("f", 272), u("f", 276)
        qfac = pixdim[0] if pixdim[0] in (-1.0, 1.0) else 1.0
        R = _quaternion_to_matrix(b, c, d, qfac)
        affine = np.eye(4)
        affine[:3, :3] = R @ np.diag(pixdim[1:4])
        affine[:3, 3] = (qx, qy, qz)
    else:
        affine = np.diag(list(pixdim[1:4]) + [1.0])
    return data, affine


def _affine_ras_to_image(data_ijk: np.ndarray, affine_ras: np.ndarray) -> MedicalImage:
    """Convert nib-style (i,j,k) data + RAS affine → sitk-convention image."""
    # world LPS = diag(-1,-1,1) @ RAS
    affine = np.diag([-1.0, -1.0, 1.0, 1.0]) @ affine_ras
    M = affine[:3, :3]
    spacing = np.linalg.norm(M, axis=0)
    spacing[spacing == 0] = 1.0
    direction = M / spacing
    if data_ijk.ndim == 3:
        arr = np.ascontiguousarray(data_ijk.transpose(2, 1, 0))
    else:  # (i, j, k, c) → (z, y, x, c)
        arr = np.ascontiguousarray(data_ijk.transpose(2, 1, 0, 3))
    return MedicalImage(
        arr,
        spacing=tuple(spacing),
        origin=tuple(affine[:3, 3]),
        direction=tuple(direction.ravel()),
    )


def _image_to_ras_affine(img: MedicalImage) -> np.ndarray:
    affine_lps = img.affine
    return np.diag([-1.0, -1.0, 1.0, 1.0]) @ affine_lps


def _write_nifti(data_ijk: np.ndarray, affine_ras: np.ndarray) -> bytes:
    data_ijk = np.ascontiguousarray(data_ijk)
    if data_ijk.dtype not in _NIFTI_CODES:
        data_ijk = data_ijk.astype(np.float32)
    code = _NIFTI_CODES[np.dtype(data_ijk.dtype)]
    shape = data_ijk.shape
    ndim = len(shape)
    dim = [ndim] + list(shape) + [1] * (7 - ndim)
    M = affine_ras[:3, :3]
    spacing = np.linalg.norm(M, axis=0)
    spacing[spacing == 0] = 1.0

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data_ijk.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, *([1.0] * (7 - 3)))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code (scanner)
    struct.pack_into("<4f", hdr, 280, *affine_ras[0])
    struct.pack_into("<4f", hdr, 296, *affine_ras[1])
    struct.pack_into("<4f", hdr, 312, *affine_ras[2])
    hdr[344:348] = b"n+1\x00"
    body = data_ijk.transpose(tuple(range(ndim))[::-1]).tobytes()  # i fastest
    return bytes(hdr) + b"\x00\x00\x00\x00" + body


# -- MetaImage ----------------------------------------------------------------

_MET_DTYPES = {
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16,
    "MET_SHORT": np.int16,
    "MET_UINT": np.uint32,
    "MET_INT": np.int32,
    "MET_ULONG_LONG": np.uint64,
    "MET_LONG_LONG": np.int64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_CODES = {np.dtype(v): k for k, v in _MET_DTYPES.items()}


def _read_mha(raw: bytes, path: Path) -> MedicalImage:
    # header: ASCII "Key = Value" lines until ElementDataFile
    pos = 0
    fields: dict[str, str] = {}
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if "=" in line:
            k, v = line.split("=", 1)
            fields[k.strip()] = v.strip()
            if k.strip() == "ElementDataFile":
                break
        if pos >= len(raw):
            break

    ndims = int(fields.get("NDims", 3))
    size = [int(s) for s in fields["DimSize"].split()]
    dtype = np.dtype(_MET_DTYPES[fields["ElementType"]])
    nchan = int(fields.get("ElementNumberOfChannels", 1))
    spacing = [
        float(s)
        for s in fields.get(
            "ElementSpacing", fields.get("ElementSize", "1 1 1")
        ).split()
    ]
    offset = [float(s) for s in fields.get("Offset", fields.get("Position", "0 0 0")).split()]
    tm = fields.get("TransformMatrix", fields.get("Orientation"))
    if tm:
        # MetaIO stores the axis direction cosines as consecutive triplets
        # (row i = direction of index axis i); the sitk/ITK direction matrix
        # has the axis cosines as COLUMNS — transpose on the way in
        # NDims may be 2 (or >3): embed the NxN matrix into the 3x3
        # direction instead of crashing on a hardcoded (3, 3) reshape
        vals = np.array([float(s) for s in tm.split()]).reshape(ndims, ndims)
        n = min(ndims, 3)
        dm = np.eye(3)
        dm[:n, :n] = vals[:n, :n].T
        direction = list(dm.ravel())
    else:
        direction = list(np.eye(ndims).ravel())
    msb = fields.get("BinaryDataByteOrderMSB", "False").lower() == "true" or (
        fields.get("ElementByteOrderMSB", "False").lower() == "true"
    )
    if msb:
        dtype = dtype.newbyteorder(">")

    datafile = fields.get("ElementDataFile", "LOCAL")
    if datafile.upper() == "LOCAL":
        body = raw[pos:]
    else:
        body = (path.parent / datafile).read_bytes()

    if fields.get("CompressedData", "False").lower() == "true":
        body = zlib.decompress(body)

    count = int(np.prod(size)) * nchan
    data = np.frombuffer(body, dtype=dtype, count=count)
    # MetaImage stores x fastest → C-order shape (z, y, x[, c])
    shape = size[::-1] + ([nchan] if nchan > 1 else [])
    if nchan > 1:
        data = data.reshape(size[::-1] + [nchan])
    else:
        data = data.reshape(shape)
    if ndims == 2:
        # promote to a single-slice 3D volume: MedicalImage's contract (and
        # every downstream consumer) is (z, y, x); the 2D direction matrix
        # was embedded into the (x, y) block of the 3x3 above
        data = data[None]
    return MedicalImage(
        data.astype(dtype.newbyteorder("=")),
        spacing=tuple(spacing[:3] + [1.0] * (3 - len(spacing))),
        origin=tuple(offset[:3] + [0.0] * (3 - len(offset))),
        direction=tuple(direction if len(direction) == 9 else np.eye(3).ravel()),
    )


def _write_mha(img: MedicalImage, compressed: bool = False) -> bytes:
    data = np.ascontiguousarray(img.data)
    if data.dtype not in _MET_CODES:
        data = data.astype(np.float32)
    nchan = data.shape[3] if data.ndim == 4 else 1
    size = (data.shape[2], data.shape[1], data.shape[0])
    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        # axis cosines as rows in the file (transpose of the sitk direction)
        "TransformMatrix = "
        + " ".join(f"{v:g}" for v in img.direction_matrix.T.ravel()),
        "Offset = " + " ".join(f"{v:g}" for v in img.origin),
        "CenterOfRotation = 0 0 0",
        "ElementSpacing = " + " ".join(f"{v:g}" for v in img.spacing),
        f"DimSize = {size[0]} {size[1]} {size[2]}",
    ]
    if nchan > 1:
        lines.append(f"ElementNumberOfChannels = {nchan}")
    lines += [
        f"ElementType = {_MET_CODES[np.dtype(data.dtype)]}",
        "ElementDataFile = LOCAL",
    ]
    body = data.tobytes()
    if compressed:
        body = zlib.compress(body)
    return ("\n".join(lines) + "\n").encode("ascii") + body


# -- public API ----------------------------------------------------------------

def read_image(path: Union[str, Path]) -> MedicalImage:
    """Read a .nii / .nii.gz / .mha / .mhd image into a MedicalImage."""
    path = Path(path)
    name = path.name.lower()
    raw = path.read_bytes()
    if name.endswith(".gz"):
        raw = gzip.decompress(raw)
        name = name[:-3]
    if name.endswith(".nii"):
        data, affine = _read_nifti(raw)
        return _affine_ras_to_image(data, affine)
    if name.endswith(".mha") or name.endswith(".mhd"):
        return _read_mha(raw, path)
    raise ValueError(f"unsupported image format: {path}")


def write_image(img: MedicalImage, path: Union[str, Path]) -> None:
    """Write a MedicalImage as .nii / .nii.gz / .mha."""
    path = Path(path)
    name = path.name.lower()
    if name.endswith(".nii") or name.endswith(".nii.gz"):
        affine_ras = _image_to_ras_affine(img)
        if img.data.ndim == 3:
            data_ijk = img.data.transpose(2, 1, 0)
        else:
            data_ijk = img.data.transpose(2, 1, 0, 3)
        blob = _write_nifti(data_ijk, affine_ras)
        if name.endswith(".gz"):
            blob = gzip.compress(blob)
        path.write_bytes(blob)
    elif name.endswith(".mha"):
        path.write_bytes(_write_mha(img))
    else:
        raise ValueError(f"unsupported image format: {path}")


def load_volume_nib_order(path: Union[str, Path]) -> tuple[np.ndarray, np.ndarray]:
    """Load a volume as nibabel would: (i, j, k) data + RAS affine.

    This is the convention of the reference CLI pipelines
    (``nib.load(...).get_fdata()``, convex_adam_MIND.py:225-226).
    """
    path = Path(path)
    name = path.name.lower()
    if name.endswith(".gz"):
        name = name[: -len(".gz")]  # suffix removal — rstrip(".gz") strips
        # any trailing run of '.', 'g', 'z' CHARACTERS, not the suffix
    if name.endswith((".mha", ".mhd")):
        img = read_image(path)
        data = img.data.transpose(2, 1, 0) if img.data.ndim == 3 else img.data.transpose(2, 1, 0, 3)
        return np.asarray(data, np.float64), _image_to_ras_affine(img)
    raw = path.read_bytes()
    if path.name.lower().endswith(".gz"):
        raw = gzip.decompress(raw)
    data, affine = _read_nifti(raw)
    return np.asarray(data, np.float64), affine


def save_volume_nib_order(
    data_ijk: np.ndarray, affine_ras: np.ndarray, path: Union[str, Path]
) -> None:
    """Save (i, j, k)-ordered data with a RAS affine (nib.save equivalent)."""
    path = Path(path)
    blob = _write_nifti(np.asarray(data_ijk), np.asarray(affine_ras, float))
    if path.name.lower().endswith(".gz"):
        blob = gzip.compress(blob)
    path.write_bytes(blob)
