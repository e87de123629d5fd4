"""``csrc/cost_volume.cu`` and ``csrc/warp.cu``, built for the host and run
on CPU tensors, with the arguments a slab of a volume split along H passes
them (the cost volume's moving row offset, the data term's first lattice
row) and with their defaults.

As ``tests/test_torch_mind_host.py`` does for ``mind.cu``: the CUDA source
is compiled with ``g++`` against ``tests/cuda_host_emu.h`` after its
``asm`` statements (``cp.async``), its shared-memory declarations and its
``<<<...>>>`` launches are rewritten into the emulation's calls, and its C
entries run through ctypes as the wrappers call them on the card.  Each
must equal the plain version to the bit (the data term's ``sum(res^2)``
adds in another order: 1e-5 relative).  What only the card shows stays with
``chip_smoke.py``.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from convexadam_torch.kernels.cost_volume import cost_volume_block_plain, kernel_for
from convexadam_torch.kernels.warp import sub_extent, warp_ssd_loss_grad_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent


def host_source(src: str) -> str:
    """A kernel source with its PTX, shared memory and launches as calls of
    the emulation."""
    src = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global \[%0\], \[%1\], 4, %2;\\n" ::'
                 r'"r"\((\w+)\),\s*"l"\((\w+)\),\s*"r"\((.*?)\)\s*: "memory"\);',
                 r"emu_cp_async4(\1, \2, \3);", src, flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.c[ag]\.shared\.global \[%0\], \[%1\], '
                 r'(8|16), %2;\\n" ::"r"\((\w+)\),\s*"l"\((\w+)\),\s*"r"\((.*?)\)\s*: "memory"\);',
                 r"emu_cp_async(\2, \3, \1, \4);", src, flags=re.S)
    src = src.replace('asm volatile("cp.async.wait_all;\\n" ::: "memory");', ";")
    src = src.replace('asm volatile("cp.async.commit_group;\\n" ::: "memory");', ";")
    src = re.sub(r'asm volatile\("cp\.async\.wait_group %0;\\n" ::"n"\([^)]*\) : "memory"\);', ";",
                 src)
    src = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                 r"float* \1 = reinterpret_cast<float*>(emu_smem);", src)
    src = re.sub(r"\b__shared__\b", "static", src)
    src = re.sub(r"([\w:]+(?:<[\w, :]+>)?)<<<([^,]+), ([^,]+), [^,]+, [^>]+>>>\((.*?)\);",
                 r"emu_launch(\2, \3, [&] { \1(\4); });", src, flags=re.S)
    assert not re.search(r"\basm\b", src) and "<<<" not in src
    return '#include "cuda_host_emu.h"\n' + src


def _build(tmp: pathlib.Path, name: str) -> ctypes.CDLL:
    inc = tmp / "inc"
    inc.mkdir(exist_ok=True)
    shutil.copy(ROOT / "tests" / "cuda_host_emu.h", inc)
    for h in ("cuda_runtime.h", "cuda_bf16.h"):
        (inc / h).write_text('#pragma once\n#include "cuda_host_emu.h"\n')
    cpp = tmp / f"{name}_host.cpp"
    cpp.write_text(host_source((ROOT / "convexadam_torch" / "csrc" / f"{name}.cu").read_text()))
    lib = tmp / f"lib{name}_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-fPIC", "-shared", "-pthread", "-Wno-unknown-pragmas",
                    f"-I{ROOT / 'convexadam_torch' / 'csrc'}", f"-I{inc}", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float  # noqa: E741


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slab_host")
    cv = _build(tmp, "cost_volume").cost_volume
    cv.argtypes, cv.restype = [P, P, P] + [I] * 11 + [P], I
    wlib = _build(tmp, "warp")
    ssd = wlib.warp_ssd_loss_grad
    ssd.argtypes = [P] * 6 + [I] * 4 + [F] * 4 + [I] * 4 + [P]
    ssd.restype = I
    return cv, ssd, wlib.warp_ssd_threads()


def _cost(cv, fix, mov, q, kh0, nkh, metric, mov_row0):
    C, h, w, d = fix.shape
    K = 2 * q + 1
    out = torch.full((K * K * nkh, h, w, d), float("nan"))
    general = kernel_for(q) == "cost_volume_general_kernel"
    err = cv(fix.data_ptr(), mov.data_ptr(), out.data_ptr(), C, h, w, d, q, int(general),
             int(metric == "sad"), kh0, nkh, mov.shape[1], mov_row0, None)
    assert err == 0
    return out


# (q, shape): the compiled kernel's tile at a d that 4 divides and one it
# does not, the general kernel (q = 0, 8) with 17 channels in two chunks
COST_CASES = [(1, (3, 7, 5, 8)), (2, (3, 7, 5, 6)), (0, (17, 6, 5, 9)), (8, (2, 9, 3, 4))]


@pytest.mark.parametrize("metric", ["ssd", "sad"])
@pytest.mark.parametrize("q,shape", COST_CASES)
def test_cost_volume_offsets_equal_plain(libs, q, shape, metric, rng):
    """The whole volume (offset 0, equal shapes) and a slab's (the fixed
    rows 2 .. h - 3, the moving rows from 2 - q, clipped, and a row short
    of them), the volume and one candidate block, equal to the plain
    version to the bit."""
    cv = libs[0]
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    K, h = 2 * q + 1, shape[1]
    a, b = 2, h - 2
    slabs = [(f, m, 0), (f[:, a:b].contiguous(), m[:, max(0, a - q):h].contiguous(),
                         max(0, a - q) - a),
             (f[:, a:b].contiguous(), m[:, a + 1:b].contiguous(), 1)]
    for fix, mov, m0 in slabs:
        for kh0, nkh in ((0, K), (q, 1)):
            got = _cost(cv, fix, mov, q, kh0, nkh, metric, m0)
            assert torch.equal(got, cost_volume_block_plain(fix, mov, q, kh0, nkh, metric, m0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_data_term_first_row_equals_plain(libs, stride, dtype, rng):
    """The whole lattice and the slabs of its rows from ``row0``: the rows to
    the bit, ``sum(res^2)`` to 1e-5 relative, against the plain version; a
    slab's rows are the whole lattice's."""
    _, ssd, threads = libs
    C, H, W, D = 3, 11, 7, 6
    mov = torch.from_numpy(rng.standard_normal((C, H, W, D)).astype(np.float32)).to(dtype)
    sub = tuple(sub_extent(n, stride) for n in (H, W, D))
    disp = torch.from_numpy((rng.random((3, *sub)) * 6 - 3).astype(np.float32))
    fix = torch.from_numpy(rng.standard_normal((C, *sub)).astype(np.float32))
    fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
    whole = None
    for r0, r1 in ((0, sub[0]), (0, 2), (2, sub[0] - 1), (sub[0] - 1, sub[0])):
        d = disp[:, r0:r1].contiguous()
        fx = fix[:, r0:r1].reshape(C, -1).contiguous()
        N = d[0].numel()
        parts = -(-N // threads)
        buf = torch.full((3 * N + parts + 1,), float("nan"))
        ptr = buf.data_ptr()
        err = ssd(mov.data_ptr(), d.data_ptr(), fx.data_ptr(), ptr, ptr + 4 * 3 * N,
                  ptr + 4 * (3 * N + parts), C, H, W, D, *fac, 0.5, stride,
                  int(dtype == torch.bfloat16), r0, r1 - r0, None)
        assert err == 0
        ssq_p, rows_p = warp_ssd_loss_grad_plain(mov, d, fx, fac, 0.5, stride, r0)
        rows = buf[:3 * N].view(3, N)
        assert torch.equal(rows, rows_p)
        assert float(buf[3 * N + parts]) == pytest.approx(float(ssq_p), rel=1e-5)
        if whole is None:
            whole = rows.reshape(3, *sub)
        assert torch.equal(rows, whole[:, r0:r1].reshape(3, -1))


def test_data_term_refuses_rows_past_the_lattice(libs):
    """A slab whose rows run past the lattice is refused before a launch."""
    _, ssd, _ = libs
    z = torch.zeros(64)
    assert ssd(z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(),
               z.data_ptr(), 1, 4, 2, 2, 1.0, 1.0, 1.0, 1.0, 1, 0, 3, 2, None) == 1
