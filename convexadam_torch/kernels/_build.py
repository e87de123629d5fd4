"""Build and load the hand-written CUDA kernels of ``convexadam_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>_<hash>.so`` at the checkout root (a directory
``.gitignore`` lists) and loaded with ``ctypes``.  The hash covers every file
under ``csrc/`` and the flags, so an edited source rebuilds at first use and
an unchanged one is loaded as built.  :func:`build_all` starts one ``nvcc``
per source, all together, and waits for them; ``ptxas``'s resource report
of each build (registers and spills per kernel) is kept beside the library
and read by :func:`resource_usage`.

The sources have a plain C interface: every entry point takes pointers and
the CUDA stream as ``void*`` (declared ``c_void_p`` here, so ctypes never
cuts a 64-bit pointer), and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

from convexadam_torch.utils import trace

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("mind", "cost_volume", "warp", "edt", "convex", "box")

_LIBS: dict = {}
_ENTRIES: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of convexadam_torch are built from "
        "csrc/ at first use and need the CUDA toolkit"
    )


@functools.lru_cache(maxsize=None)
def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    trace.count("kernel_builds", len(procs))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
        trace.count("kernel_loads")
    return lib


def bind(name: str, entry: str, argtypes) -> "ctypes._CFuncPtr":
    """Entry point ``entry`` of ``csrc/<name>.cu`` with its argument types
    declared and an ``int`` (the ``cudaError_t``) result."""
    fn = _ENTRIES.get((name, entry))
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, entry)] = fn
    return fn


def resource_usage(name: str) -> "dict[str, dict]":
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu`` (by
    mangled name), from ``ptxas -v``'s report of its build."""
    usage: dict = {}
    kernel = None
    for line in _lib_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = usage.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel is not None:
            kernel["spill_stores"], kernel["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            kernel["registers"] = int(m.group(1))
    return usage


def check(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {entry} failed with cudaError {err}")


def call_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with the current CUDA stream of ``device`` (its
    raw handle), run with ``device`` current; the device is switched only
    when another one is current."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def require_cuda(t: torch.Tensor, what: str) -> None:
    """A kernel wrapper takes the plain path only for CPU tensors; any
    other device must be CUDA."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {t.device}")


def require(t: torch.Tensor, what: str, dtypes, shape) -> None:
    """Raise unless ``t`` is contiguous, of one of ``dtypes`` and of
    ``shape`` (``None`` entries match any extent)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{what}: shape {tuple(t.shape)} does not match {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741
F = ctypes.c_float
