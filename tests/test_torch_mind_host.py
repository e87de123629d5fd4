"""``csrc/mind.cu`` itself, built for the host and run on CPU tensors.

The CUDA source is compiled with ``g++`` against ``tests/cuda_host_emu.h``
(each CUDA thread a ``std::thread``, ``__syncthreads`` a barrier, the
bf16x2 instructions computed in float and rounded to bfloat16), after its
``asm`` statements and ``<<<...>>>`` launches are rewritten into calls of
that header.  Its C entry ``mind_ssd_stats`` then runs through ctypes, as
the wrapper calls it on the card, and must equal the plain version to the
bit: the dispatch, the compiled kernels and the general kernel's staging,
index arithmetic, order of additions and rounding, for pairs and volumes
the card runs, without the card.  What only the card shows (nvcc's
compilation, registers, speed) stays with ``chip_smoke.py``.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from convexadam_torch.kernels.mind import COMPILED_PAIRS, general_plan, kernel_for
from convexadam_torch.kernels.mind import mind_ssd_stats_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
CUDA_INVALID_VALUE = 1


def host_source(src: str) -> str:
    """``mind.cu`` with its PTX and its launches as calls of the emulation."""
    src = re.sub(r'asm\("(\S+) %0, %1, %2;" : "=r"\((\w+)\) : "\w"\((\w+)\), "\w"\((\w+)\)\);',
                 r'\2 = emu_asm("\1", \3, \4);', src)
    src = src.replace("extern __shared__ float4 smem_raw[];", "float4* smem_raw = emu_smem;")
    src = re.sub(r"(\w+<[\w, ]+>)<<<(\w+), (\w+), \w+, \w+>>>\((.*?)\);",
                 r"emu_launch(\2, \3, [&] { \1(\4); });", src, flags=re.S)
    assert not re.search(r"\basm\(", src) and "<<<" not in src
    return '#include "cuda_host_emu.h"\n' + src


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    d = tmp_path_factory.mktemp("mind_host")
    inc = d / "inc"
    inc.mkdir()
    shutil.copy(ROOT / "tests" / "cuda_host_emu.h", inc)
    for name in ("cuda_runtime.h", "cuda_bf16.h"):
        (inc / name).write_text('#pragma once\n#include "cuda_host_emu.h"\n')
    cpp = d / "mind_host.cpp"
    cpp.write_text(host_source((ROOT / "convexadam_torch" / "csrc" / "mind.cu").read_text()))
    lib = d / "libmind_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-fPIC", "-shared", "-pthread", "-Wno-unknown-pragmas",
                    f"-I{ROOT / 'convexadam_torch' / 'csrc'}", f"-I{inc}", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).mind_ssd_stats
    P, I = ctypes.c_void_p, ctypes.c_int  # noqa: E741
    fn.argtypes = [P, P, P, I, I, I, I, I, I, I, I, I, P]
    fn.restype = I
    return fn


def run(entry, x, r, d, general, halo=False, cw=0):
    H, W, D = x.shape
    mind = torch.full((12, H, W, D), float("nan"), dtype=x.dtype)
    var = torch.full((H, W, D), float("nan"))
    err = entry(x.data_ptr(), mind.data_ptr(), var.data_ptr(), H, W, D, r, d, int(general),
                int(halo), cw, int(x.dtype == torch.bfloat16), None)
    return err, mind, var


def assert_equal_to_plain(entry, shape, r, d, dtype, seed, **staging):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
                         * 50).to(dtype)
    general = kernel_for(r, d) == "mind_general_kernel"
    if general and not staging:
        halo, cw, _ = general_plan(r, d, x.element_size())
        staging = {"halo": halo, "cw": cw}
    err, mind, var = run(entry, x, r, d, general or "cw" in staging, **staging)
    assert err == 0
    mp, vp = mind_ssd_stats_plain(x, r, d)
    assert torch.equal(mind.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       mp.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(var, vp)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,d", sorted(COMPILED_PAIRS))
def test_compiled_kernels_equal_plain(entry, r, d, dtype):
    """Each compiled pair through its own instance, on a volume across two
    64-voxel D tiles with an odd D (single stores)."""
    assert_equal_to_plain(entry, (9, 11, 67), r, d, dtype, seed=r * 4 + d)


# r or d 0, pairs whose old key r * 4 + d fell on a compiled pair's, r = 4
# (the halo staged; the H sums' head, middle and tail), halos past shared
# memory (operands from global memory), one past the volume, and the
# compiled pairs through the general kernel
GENERAL_CASES = [((13, 17, 9), 0, 2), ((5, 9, 11), 1, 0), ((9, 11, 69), 1, 5), ((13, 17, 9), 2, 7),
                 ((9, 11, 70), 4, 1), ((13, 17, 9), 4, 1), ((6, 9, 7), 1, 12), ((6, 9, 7), 6, 6),
                 ((5, 7, 9), 8, 16), ((9, 11, 70), 3, 3), ((5, 9, 67), 1, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,r,d", GENERAL_CASES)
def test_general_kernel_equals_plain(entry, shape, r, d, dtype):
    if kernel_for(r, d) == "mind_kernel":
        halo, cw, _ = general_plan(r, d, 4 if dtype == torch.float32 else 2)
        assert_equal_to_plain(entry, shape, r, d, dtype, seed=r + 17 * d, halo=halo, cw=cw)
    else:
        assert_equal_to_plain(entry, shape, r, d, dtype, seed=r + 17 * d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("halo,cw,r,d", [(False, 3, 4, 1), (True, 1, 1, 2), (False, 2, 0, 3),
                                         (True, 5, 2, 1)])
def test_general_kernel_stagings_equal_plain(entry, halo, cw, r, d, dtype):
    """Either staging with the H sums in chunks of W columns (cw below the
    region's FW + 2r columns), where shared memory would allow more."""
    assert_equal_to_plain(entry, (9, 11, 13), r, d, dtype, seed=cw, halo=halo, cw=cw)


def test_dispatch_refuses_what_it_has_no_instance_for(entry):
    """``general == 0`` launches only the instance of its own (r, d): a pair
    outside {1, 2, 3}^2 is refused, never computed by another pair's
    kernel; a chunk width outside 1..FW + 2r is refused too."""
    x = torch.zeros((4, 4, 4))
    for r, d in [(1, 5), (0, 5), (2, 7), (1, 9), (4, 1), (0, 1)]:
        err, mind, _ = run(entry, x, r, d, general=False)
        assert err == CUDA_INVALID_VALUE and torch.isnan(mind).all()
    assert run(entry, x, 1, 5, general=True, cw=0)[0] == CUDA_INVALID_VALUE
    assert run(entry, x, 1, 5, general=True, cw=11)[0] == CUDA_INVALID_VALUE
