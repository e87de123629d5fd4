"""The cost volume's zero-padded 3^3 box passes: the wrapper of ``csrc/box.cu``
and its plain version.

Replaces no Pallas kernel: the JAX package smooths its cost volume with XLA
(``convexadam_tpu/core/cost_volume.py:correlate``).  :func:`box_mean3`
returns ``passes`` zero-padded 3^3 box means of a float32 volume (..., h, w,
d), each ``F.avg_pool3d(x, 3, stride=1, padding=1)`` over the last three
axes to the bit: every output adds its window's 27 terms in ATen's order
and divides by 27, the reference's rounding (one-hot semantic features give
exactly tied costs, and the argmin takes the first minimum).

On the card one or two passes are one launch of ``box_mean3_kernel<PASSES>``
(more chain launches of two and one), which reads the volume once and
writes the result once; its shape comes from :func:`launch_plan`.  Each
launch adds one to ``LAUNCHES["box_mean3"]`` and counts ``box_passes.kernel``
in the program's record (:mod:`convexadam_torch.utils.trace`).  CPU tensors
take the plain version (:func:`~convexadam_torch.core.smoothing.window_mean3d`
once a pass) and count ``box_passes.plain``.  Every call is a ``convex.box``
span of the record; the cost volume's callers hold it inside their
``convex.cost_volume`` span.  No call makes the host wait.
"""

from __future__ import annotations

import functools

import torch

from convexadam_torch.core.smoothing import window_mean3d
from convexadam_torch.kernels import LAUNCHES, _build
from convexadam_torch.kernels.convex import sm_count
from convexadam_torch.utils import trace

RY = 4  # outputs a thread along w (csrc/box.cu)
NSTAGE = 4  # raw planes in the kernel's shared-memory ring
MAX_THREADS = 512
# threads along d: whole half-warps, so that a warp's shared-memory reads
# fall on 32 banks (csrc/box.cu:row_stride)
COLUMNS = (16, 32, 48, 64, 80, 96, 112, 128)
# a block's shared memory at most: two blocks an SM
SMEM_BYTES = 110 * 1024
# registers a thread (ptxas's report of the kernels, in chip_smoke.py's
# output) and warps an SM holds at most, for the residency estimate
REGISTERS, WARPS_PER_SM = 64, 64
# instructions an output lane of a pass takes (27 adds, the window's loads,
# the division) against one copied element: weights of the work estimate
LANE_WORK, COPY_WORK = 40, 5
MIN_SEGMENT = 8  # h planes a segment at least


def box_mean3_plain(x: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` calls of ``F.avg_pool3d(x, 3, stride=1, padding=1)`` over
    the last three axes (:func:`window_mean3d`)."""
    for _ in range(passes):
        x = window_mean3d(x, 3, stride=1, padding=1)
    return x


def _tiles(n: int, span: int) -> int:
    return -(-n // span)


def _resident(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes an SM holds at once
    (an H100's 2048 threads, 65536 registers, 227 KB of shared memory)."""
    return min(32, 2048 // threads, 65536 // (threads * REGISTERS), 232448 // smem)


def chunk_floats(d: int) -> int:
    """Floats a copy of the kernel moves (``csrc/box.cu:dispatch``, for an
    aligned volume): 4 where d is a multiple of 4, else 2 where it is even,
    else 1."""
    return 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1


def row_stride(tz: int, vw: int) -> int:
    """``csrc/box.cu:row_stride``: floats a row of a plane in shared
    memory."""
    return tz + (12 if vw == 4 else 4)


@functools.lru_cache(maxsize=None)
def launch_plan(c: int, h: int, w: int, d: int, passes: int, sms: int) -> "tuple[int, ...]":
    """``(ty, tz, sy, sz, nseg)`` of a launch over ``c`` channels of (h, w,
    d) on a card of ``sms`` SMs (``csrc/box.cu``): of the thread shapes
    (``ty`` rows of :data:`RY` outputs along w, ``tz`` in :data:`COLUMNS`
    along d, at most :data:`MAX_THREADS`) and of the cut of each extent (``sy``
    / ``sz`` 1: tiles of ``RY ty - 2`` rows / ``tz - 2`` columns that read a
    grown first pass; 0: one tile spans it; one pass cuts tiles of ``RY ty``
    / ``tz``), the least work a plane (output lanes of every pass, whole warps,
    and copies) over the square root of the share of an SM's warps its
    blocks keep resident (timed on an H100 at every class of the
    benchmark's cells, this picks shapes within 4% of the fastest of the
    eight of least work), then the larger block; then the fewest h segments
    (of at least :data:`MIN_SEGMENT` planes) that give every SM as many
    blocks as it holds at once."""
    best = None
    vw = chunk_floats(d)
    for tz in COLUMNS:
        for ty in range(1, MAX_THREADS // tz + 1):
            rows, cols = RY * ty, tz
            cuts = (0, 1) if passes == 2 else (0,)
            for sy in cuts:
                if passes == 2 and sy == 0 and rows < w:
                    continue
                for sz in cuts:
                    if passes == 2 and sz == 0 and cols < d:
                        continue
                    tile_w, tile_d = rows - 2 * sy, cols - 2 * sz
                    if tile_w < 1 or tile_d < 1:
                        continue
                    rw = row_stride(tz, vw)
                    smem = (NSTAGE + 2 * (passes == 2)) * (rows + 2) * rw * 4
                    if smem > SMEM_BYTES:
                        continue
                    tiles = _tiles(w, tile_w) * _tiles(d, tile_d)
                    threads = -(-ty * tz // 32) * 32
                    copies = (rows + 2) * rw // vw
                    work = tiles * (passes * LANE_WORK * threads * RY + COPY_WORK * copies)
                    resident = _resident(threads, smem)
                    warps = min(WARPS_PER_SM, resident * threads // 32)
                    key = (work * (WARPS_PER_SM / warps) ** 0.5, -ty * tz)
                    if best is None or key < best[0]:
                        best = (key, ty, tz, sy, sz, tiles, resident)
    _, ty, tz, sy, sz, tiles, resident = best
    want = sms * resident
    nseg = min(max(1, h // MIN_SEGMENT), max(1, -(-want // (c * tiles))))
    return ty, tz, sy, sz, nseg


@functools.lru_cache(maxsize=None)
def _entry():
    P, I = _build.P, _build.I  # noqa: E741
    return _build.bind("box", "box_mean3", (P, P, I, I, I, I, I, I, I, I, I, I, P))


def _launch(x: torch.Tensor, passes: int) -> torch.Tensor:
    what = "box_mean3"
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: expected contiguous float32 costs, got {x.dtype} with "
                         f"strides {x.stride()}")
    h, w, d = x.shape[-3:]
    c = x.numel() // (h * w * d)
    out = torch.empty_like(x)
    plan = launch_plan(c, h, w, d, passes, sm_count(x.device))
    err = _build.call_on(x.device, _entry(), x.data_ptr(), out.data_ptr(), c, h, w, d, passes,
                         *plan)
    _build.check(err, what)
    LAUNCHES["box_mean3"] += 1
    trace.count("box_passes.kernel")
    return out


def box_mean3(x: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` zero-padded 3^3 box means of ``x`` (..., h, w, d) over its
    last three axes, float32 (module docstring); ``x`` itself for no pass or
    no value (a slab of no rows).  On the card ``x`` is contiguous float32,
    and the result a new tensor beside it.  A ``convex.box`` span."""
    with trace.span("convex.box"):
        if passes < 1 or x.numel() == 0:
            return x
        if x.device.type == "cpu":
            trace.count("box_passes.plain")
            return box_mean3_plain(x, passes)
        _build.require_cuda(x, "box_mean3")
        while passes > 0:
            x = _launch(x, min(passes, 2))
            passes -= 2
        return x
