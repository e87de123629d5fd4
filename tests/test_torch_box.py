"""The cost volume's box passes (``kernels/box.py``, ``csrc/box.cu``).

On the CPU:

* ``csrc/box.cu``, built for the host against ``tests/cuda_host_emu.h`` (as
  ``tests/test_torch_slab_host.py`` builds its sources), equals to the bit
  a plain version that adds each window's 27 terms in ATen's order (h, then
  w, then d, each ascending) and divides by 27, after one and two passes:
  extents of 1, 2 and 3 and odd ones, tiles cut raggedly along w and d, h in
  segments, channel counts from 7 to 4913, integer costs with many exact
  ties and normal ones, planted infs and NaNs;
* the launch plan covers every class of the benchmark's cells within the
  kernel's limits, and the entry refuses what it has no launch for;
* CPU tensors take ``window_mean3d`` (``F.avg_pool3d``, equal to the
  ATen-order sums) and count ``box_passes.plain``.

Marked ``card`` (skipped here): the kernel against ``F.avg_pool3d`` applied
once and twice at every class of the four cells and of ``chip_smoke.py``'s
runs; the dense, streamed and
tensor-parallel convex fields against one another and the path of plain box
passes; a slab's costs against the whole volume's rows.  Run them with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_box.py -m card``.
"""

import ctypes
import pathlib
import sys

import numpy as np
import pytest
import torch
from test_torch_convex_fold import _semantic_features
from test_torch_slab_host import _build as build_host
from torch.profiler import ProfilerActivity, profile

from convexadam_torch.core import convex as tconvex
from convexadam_torch.core import cost_volume as tcv
from convexadam_torch.kernels import LAUNCHES
from convexadam_torch.kernels import box
from convexadam_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import BOX_CLASSES  # noqa: E402

torch.set_num_threads(2)

# (channels, h, w, d) of every (grid_sp, disp_hw) class of the benchmark's
# four cells and of chip_smoke.py's own runs, as its phase 3h holds them
CLASSES = BOX_CLASSES


def aten_order(x: np.ndarray, passes: int) -> np.ndarray:
    """``passes`` zero-padded 3^3 box means of (C, h, w, d): each output adds
    its window's terms one at a time, h offset outermost, then w, then d,
    from +0 (a term outside the volume adds +0, as skipping it does), and
    divides by 27, in float32."""
    x = x.astype(np.float32)
    for _ in range(passes):
        c, h, w, d = x.shape
        xp = np.zeros((c, h + 2, w + 2, d + 2), np.float32)
        xp[:, 1:-1, 1:-1, 1:-1] = x
        acc = np.zeros_like(x)
        with np.errstate(invalid="ignore", over="ignore"):
            for a in range(3):
                for b in range(3):
                    for e in range(3):
                        acc = acc + xp[:, a:a + h, b:b + w, e:e + d]
            x = acc / np.float32(27)
    return x


def same_bits(a, b) -> bool:
    """Equal to the bit where a number, NaN where the other is NaN (compared
    64 channels at a time: a card's volume and its masks fit beside it)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return False
    for x, y in zip(a.reshape(len(a), -1).split(64), b.reshape(len(b), -1).split(64)):
        nx, ny = torch.isnan(x), torch.isnan(y)
        if not (torch.equal(nx, ny) and torch.equal(x[~nx].view(torch.int32),
                                                     y[~ny].view(torch.int32))):
            return False
    return True


def costs(shape, kind, seed):
    """Integer costs 0..3 (``ties``: exact sums, many equal) or normal ones,
    with infs of both signs and NaNs planted."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(0, 4, shape).astype(np.float32)
    else:
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    flat[rng.choice(n, max(1, n // 97), replace=False)] = np.inf
    flat[rng.choice(n, max(1, n // 211), replace=False)] = -np.inf
    flat[rng.choice(n, max(1, n // 151), replace=False)] = np.nan
    return torch.from_numpy(x)


def valid(plan, passes, w, d) -> bool:
    """Whether the host entry takes ``plan`` (``csrc/box.cu``)."""
    ty, tz, sy, sz, nseg = plan
    if passes == 1:
        return True
    return (sy or box.RY * ty >= w) and (sz or tz >= d) and box.RY * ty - 2 * sy >= 1


# ---------------------------------------------------------------------------
# csrc/box.cu on the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_box(tmp_path_factory):
    fn = build_host(tmp_path_factory.mktemp("box_host"), "box").box_mean3
    P, I = ctypes.c_void_p, ctypes.c_int  # noqa: E741
    fn.argtypes = [P, P] + [I] * 10 + [P]
    fn.restype = I
    return fn


def host_run(entry, x, passes, plan):
    h, w, d = x.shape[-3:]
    out = torch.full_like(x, 7.0)
    err = entry(x.data_ptr(), out.data_ptr(), x.numel() // (h * w * d), h, w, d, passes, *plan,
                None)
    assert err == 0, plan
    return out


# (C, h, w, d): extents of 1, 2 and 3, odd ones, a d past one 64-column tile
# and a w past one 32-row one; d odd, even and a multiple of 4, so that the
# copies move 4, 8 and 16 bytes
SHAPES = [(2, 1, 1, 1), (2, 2, 1, 3), (3, 3, 2, 2), (2, 5, 9, 11), (3, 13, 17, 19),
          (2, 10, 23, 37), (1, 4, 3, 70), (1, 9, 41, 5), (2, 6, 13, 36), (1, 5, 9, 68)]
# beside the launch plan's own: both extents cut into tiles of 2 or 6 rows
# and 14 or 30 columns (ragged), with h in two or three segments, and cuts
# of one extent only
FORCED = [(1, 16, 1, 1, 1), (1, 16, 1, 1, 3), (2, 16, 1, 1, 2), (12, 16, 0, 1, 1),
          (1, 80, 1, 0, 2), (1, 32, 1, 1, 2), (2, 96, 1, 0, 1)]


@pytest.mark.parametrize("kind", ["ties", "normal"])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_host_kernel_equals_aten_order(host_box, shape, passes, kind):
    x = costs(shape, kind, seed=sum(shape) + passes)
    want = aten_order(x.numpy(), passes)
    c, h, w, d = shape
    plans = [box.launch_plan(c, h, w, d, passes, 132)] + FORCED
    ran = 0
    for ty, tz, sy, sz, nseg in plans:
        plan = (ty, tz, sy, sz, min(nseg, h))
        if not valid(plan, passes, w, d):
            continue
        assert same_bits(host_run(host_box, x, passes, plan), want), plan
        ran += 1
    assert ran >= 3


@pytest.mark.parametrize("channels", [7, 27, 125, 1331, 4913])
def test_host_kernel_takes_every_channel_count(host_box, channels):
    """One block a channel; the last channel's output ends the buffer (two
    passes only where the host's threads, one a CUDA thread, cost most)."""
    x = costs((channels, 2, 2, 5), "normal", seed=channels)
    for passes in (1, 2) if channels < 1000 else (2,):
        got = host_run(host_box, x, passes, (1, 16, 0, 0, 1))
        assert same_bits(got, aten_order(x.numpy(), passes)), passes


def test_host_kernel_sums_in_aten_order():
    """The order matters: on these costs, the plain sums in ATen's order and
    the separable (d, then w, then h) sums differ, so the equalities above
    hold the kernel to ATen's order."""
    x = costs((4, 7, 8, 9), "normal", seed=3)
    x[torch.isinf(x) | torch.isnan(x)] = 1.0
    want = torch.from_numpy(aten_order(x.numpy(), 1))
    sep = x
    for ax in (3, 2, 1):
        sep = torch.nn.functional.pad(sep, [0, 0] * (3 - ax) + [1, 1])
        n = sep.shape[ax] - 2
        sep = sep.narrow(ax, 0, n) + sep.narrow(ax, 1, n) + sep.narrow(ax, 2, n)
    assert not torch.equal(want, sep / 27)


def test_host_entry_refuses_what_it_has_no_launch_for(host_box):
    z = torch.zeros(64)
    bad = [  # (C, h, w, d, passes, ty, tz, sy, sz, nseg)
        (0, 2, 2, 2, 2, 1, 16, 0, 0, 1), (1, 2, 2, 2, 3, 1, 16, 0, 0, 1),
        (1, 2, 2, 2, 2, 0, 16, 0, 0, 1), (1, 2, 2, 2, 2, 2, 512, 0, 0, 1),
        (1, 2, 2, 2, 2, 1, 16, 2, 0, 1), (1, 2, 2, 2, 2, 1, 16, 0, 0, 3),
        (1, 2, 9, 2, 2, 2, 16, 0, 0, 1),  # an uncut tile of 8 rows, w = 9
        (1, 2, 2, 17, 2, 1, 16, 0, 0, 1),  # an uncut tile of 16 columns, d = 17
        (1, 2, 2, 2, 2, 1, 2, 0, 1, 1),  # a cut tile of no column
    ]
    for args in bad:
        assert host_box(z.data_ptr(), z.data_ptr(), *args, None) == 1, args


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("c,h,w,d", CLASSES)
def test_launch_plan_covers_every_class(c, h, w, d, passes):
    sms = 132  # an H100 SXM
    ty, tz, sy, sz, nseg = box.launch_plan(c, h, w, d, passes, sms)
    assert tz in box.COLUMNS and 1 <= ty and ty * tz <= box.MAX_THREADS
    assert valid((ty, tz, sy, sz, nseg), passes, w, d)
    planes = box.NSTAGE + 2 * (passes == 2)
    assert planes * (box.RY * ty + 2) * (tz + 2) * 4 <= box.SMEM_BYTES
    assert nseg == 1 or h // nseg >= box.MIN_SEGMENT


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("passes", [1, 2, 3])
def test_cpu_tensors_take_window_mean3d_and_count_it(passes):
    x = costs((5, 6, 7, 8), "ties", seed=passes)
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
        got = box.box_mean3(x, passes)
    assert rec.counters == {"box_passes.plain": 1}
    assert LAUNCHES == before
    assert same_bits(got, box.box_mean3_plain(x, passes))
    assert same_bits(got, aten_order(x.numpy(), passes))


def test_no_pass_is_the_costs_themselves():
    x = torch.ones((2, 3, 3, 3))
    with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
        assert box.box_mean3(x, 0) is x
    assert rec.counters == {}


def test_the_box_span_sits_inside_the_cost_volume_span():
    fix, mov = (torch.rand((3, 6, 5, 7), generator=torch.Generator().manual_seed(s))
                for s in (1, 2))
    with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
        with trace.span("convex.cost_volume"):
            tcv.correlate(fix, mov, 1)
        tcv.correlate_masked(fix, mov, torch.ones((6, 5, 7), dtype=torch.bool), 1)
        tconvex.convex_displacement(fix, mov, 1, stream_threshold=0)
        tconvex.convex_displacement_tp(fix, mov, 1)
    boxes = [s for s in rec.spans if s.name == "convex.box"]
    assert len(boxes) == 1 + 1 + 3 * 7 + 1  # the streamed path's 3 kh blocks, 7 times
    assert all(rec.spans[s.parent].name == "convex.cost_volume" for s in boxes)
    assert rec.counters["box_passes.plain"] == len(boxes)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from convexadam_torch.kernels import _build
    _build.build_all(("box",))
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("c,h,w,d", CLASSES)
def test_card_kernel_equals_avg_pool3d(c, h, w, d):
    """Integer costs (ties) with infs and NaNs at every class, one and two
    passes, one launch each, against ``F.avg_pool3d`` applied as often."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(c + h)
    x = torch.randint(0, 4, (c, h, w, d), generator=g, device=dev).float()
    flat = x.view(-1)
    n = flat.numel()
    for value, every in ((float("inf"), 97), (float("-inf"), 211), (float("nan"), 151)):
        flat[torch.randint(0, n, (n // every,), generator=g, device=dev)] = value
    for passes in (1, 2):
        before = LAUNCHES["box_mean3"]
        got = box.box_mean3(x, passes)
        assert LAUNCHES["box_mean3"] - before == 1
        want = box.box_mean3_plain(x, passes)
        assert same_bits(got, want), passes
        del got, want
    # normal costs: sums that round
    x.normal_(generator=g)
    assert same_bits(box.box_mean3(x, 2), box.box_mean3_plain(x, 2))


def _plain_box(monkeypatch):
    """The box passes of the parent's path: ``F.avg_pool3d`` once a pass."""
    monkeypatch.setattr(tcv, "box_mean3", box.box_mean3_plain)
    monkeypatch.setattr(tconvex, "box_mean3", box.box_mean3_plain)


@pytest.mark.card
@pytest.mark.parametrize("passes", [1, 2])
def test_card_dense_streamed_tp_and_plain_box_fields_are_equal(passes, monkeypatch):
    dev = _card()
    fix, mov = _semantic_features(dev)
    q = 3
    with torch.no_grad():
        kw = dict(smooth_passes=passes)
        dense = tconvex.convex_displacement(fix, mov, q, **kw)
        streamed = tconvex.convex_displacement(fix, mov, q, stream_threshold=0, **kw)
        tp = tconvex.convex_displacement_tp(fix, mov, q, **kw)
        _plain_box(monkeypatch)
        plain = tconvex.convex_displacement(fix, mov, q, **kw)
    for other in (streamed, tp, plain):
        assert torch.equal(dense, other)


@pytest.mark.card
@pytest.mark.parametrize("passes", [1, 2])
def test_card_slab_costs_equal_the_whole_volume_rows(passes):
    """A slab of fixed rows [a, b) grown by the passes' reach and its moving
    rows grown by q more (``parallel/spatial.py:_convex_slab``): the smoothed
    costs of its owned rows and their argmin equal the whole volume's."""
    dev = _card()
    fix, mov = _semantic_features(dev)
    q, h = 3, fix.shape[1]
    whole, whole_am = tcv.correlate(fix, mov, q, smooth_passes=passes)
    for a, b in ((0, 7), (7, 13), (13, h)):
        f0, f1 = max(0, a - passes), min(h, b + passes)
        m0, m1 = max(0, f0 - q), min(h, f1 + q)
        got, am = tcv.correlate(fix[:, f0:f1].contiguous(), mov[:, m0:m1].contiguous(), q,
                                smooth_passes=passes, mov_row0=m0 - f0, rows=(a - f0, b - f0))
        assert same_bits(got, whole[:, a:b]) and torch.equal(am, whole_am[a:b])
