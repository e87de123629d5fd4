"""Host-side C++ of the port, built with ``g++`` at first use and loaded
with ``ctypes``.

``edt.cpp`` is a copy of the JAX package's Felzenszwalb-Huttenlocher EDT
(``convexadam_tpu/native/edt.cpp``), compiled with the same flags, so that
its nearest-site indices break ties exactly as the JAX package's do (scipy's
``distance_transform_edt`` breaks them otherwise).  The library goes to
``build/native/_edt_<hash>.so`` at the checkout root (a directory
``.gitignore`` lists), keyed by a hash of the source and the flags; a failed
build raises with the compiler's message.  Nothing is built or loaded at
import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((_HERE / "edt.cpp").read_bytes())
    return BUILD_DIR / f"_edt_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``edt.cpp`` unless its library is built; raise on failure."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_HERE / "edt.cpp"), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the port's host EDT is built from "
                           "native/edt.cpp at first use") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for native/edt.cpp (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.edt3d_nearest.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.edt3d_nearest.restype = None
    return lib


def edt3d(mask: np.ndarray, with_distance: bool):
    """``edt3d_nearest`` of a 3-D mask (nonzero = foreground): the (3, H, W,
    D) int32 indices of each voxel's nearest zero voxel and, with
    ``with_distance``, the (H, W, D) float32 distances (else ``None``)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    if mask.ndim != 3:
        raise ValueError(f"edt3d takes a 3-D mask, got shape {mask.shape}")
    H, W, D = mask.shape
    idx = np.empty((3, H, W, D), np.int32)
    dist = np.empty((H, W, D), np.float32) if with_distance else None
    _lib().edt3d_nearest(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, D,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        None if dist is None else dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return idx, dist
