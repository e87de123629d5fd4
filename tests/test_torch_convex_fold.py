"""The convex stage's coupled argmin fold (``kernels/convex.py``,
``csrc/convex.cu``).

On the CPU:

* the plain fold equals ``torch.argmin`` of the whole coupled cost, however
  the candidates are cut into blocks (the dense path's one block, the
  streamed path's K^2-candidate ``kh`` blocks, a tensor-parallel rank's
  slices, ragged cuts) and in whatever order the blocks come, with planted
  ties and NaNs;
* CPU tensors take the plain fold and count ``coupled_argmin.plain``; no
  voxel or no candidate is no call;
* ``csrc/convex.cu`` itself, built for the host against
  ``tests/cuda_host_emu.h`` (as ``tests/test_torch_slab_host.py`` builds
  its sources), equals the plain fold to the bit at every launch shape, on
  a ragged voxel count, row-strided and misaligned costs, ties across
  split ranges and blocks, and NaNs.

Marked ``card`` (skipped here): the kernel against its plain version on the
card, and the dense, streamed and tensor-parallel convex fields against one
another and the plain path at each of the six couplings; run them with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_convex_fold.py -m card``.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_slab_host import _build as build_host
from torch.profiler import ProfilerActivity, profile

from convexadam_torch.core import convex as tconvex
from convexadam_torch.core.cost_volume import displacement_mesh
from convexadam_torch.kernels import LAUNCHES
from convexadam_torch.kernels import convex as fold
from convexadam_torch.utils import trace

torch.set_num_threads(2)


def _case(q, n, seed, nan=0):
    """Integer costs (many exact ties), the mesh of half-width ``q``, a
    field of half-voxel steps; ``nan`` costs set to NaN."""
    rng = np.random.default_rng(seed)
    k = (2 * q + 1) ** 3
    costs = torch.from_numpy(rng.integers(0, 4, (k, n)).astype(np.float32))
    if nan:
        costs.view(-1)[torch.from_numpy(rng.choice(k * n, nan, replace=False))] = float("nan")
    s = torch.from_numpy((rng.integers(-2 * q, 2 * q + 1, (3, n)) / 2).astype(np.float32))
    return costs, displacement_mesh(q), s


def _whole(costs, mesh, s, c):
    """``torch.argmin`` of the whole coupled cost and its minimum."""
    cost = fold.coupled_cost(costs, mesh, s, c)
    am = torch.argmin(cost, dim=0)
    return cost.gather(0, am[None])[0], am


def _streamed_blocks(q):
    """The streamed path's index map: block ``kh`` holds the candidates
    ``kd*K^2 + kw*K + kh``, in increasing order."""
    K = 2 * q + 1
    local = torch.arange(K * K) * K
    return [local + kh for kh in range(K)]


def _cut_blocks(k, cuts):
    bounds = [0, *cuts, k]
    return [torch.arange(a, b) for a, b in zip(bounds, bounds[1:])]


BLOCKINGS = ["dense", "streamed", "ragged", "singles"]


def _blocks(kind, q):
    k = (2 * q + 1) ** 3
    if kind == "dense":
        return [torch.arange(k)]
    if kind == "streamed":
        return _streamed_blocks(q)
    if kind == "ragged":
        return _cut_blocks(k, [1, 7, k // 2, k - 3])
    return _cut_blocks(k, list(range(1, k)))


def _rows(costs, idx):
    """The rows ``idx`` of ``costs`` as a view of rows padded to whole
    float4s (a streamed block's rows are a view of a larger slab too)."""
    n = costs.shape[1]
    buf = costs.new_full((len(idx), -(-n // 4) * 4 + 4), float("nan"))
    buf[:, :n] = costs[idx.to(costs.device)]
    return buf[:, :n]


def _fold_blocks(fn, costs, mesh, s, c, blocks, order):
    """Fold the blocks (index tensors) in ``order`` from ``(inf, K^3)``."""
    n, k3, dev = costs.shape[1], costs.shape[0], costs.device
    best = torch.full((n,), float("inf"), device=dev)
    bidx = torch.full((n,), k3, dtype=torch.int64, device=dev)
    for b in order:
        idx = blocks[b].to(dev)
        fn(_rows(costs, idx), mesh[:, idx], idx, s, c, best, bidx)
    return best, bidx


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("kind", BLOCKINGS)
@pytest.mark.parametrize("c", tconvex.COUPLING_COEFFS[::2])
def test_fold_equals_argmin_of_the_whole_coupled_cost(kind, c):
    q, n = 2, 203
    costs, mesh, s = _case(q, n, seed=len(kind), nan=5)
    blocks = _blocks(kind, q)
    order = np.random.default_rng(7).permutation(len(blocks))
    best, bidx = _fold_blocks(fold.coupled_argmin_fold, costs, mesh, s, c, blocks, order)
    want_v, want_i = _whole(costs, mesh, s, c)
    assert torch.equal(bidx, want_i)
    assert torch.equal(_bits(best), _bits(want_v))


def test_plain_fold_chunks_change_nothing(monkeypatch):
    q, n = 1, 97
    costs, mesh, s = _case(q, n, seed=3, nan=2)
    whole = _fold_blocks(fold.coupled_argmin_fold_plain, costs, mesh, s, 0.3,
                         [torch.arange(27)], [0])
    monkeypatch.setattr(fold, "COUPLED_CHUNK_BYTES", 3 * 27 * 4 * 10)  # 10 voxels a chunk
    chunked = _fold_blocks(fold.coupled_argmin_fold_plain, costs, mesh, s, 0.3,
                           [torch.arange(27)], [0])
    assert torch.equal(whole[1], chunked[1]) and torch.equal(_bits(whole[0]), _bits(chunked[0]))


def test_cpu_tensors_take_the_plain_fold_and_count_it():
    costs, mesh, s = _case(1, 40, seed=4)
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
        best, bidx = _fold_blocks(fold.coupled_argmin_fold, costs, mesh, s, 0.01,
                                  _streamed_blocks(1), range(3))
    assert rec.counters == {"coupled_argmin.plain": 3}
    assert LAUNCHES == before
    assert torch.equal(bidx, _whole(costs, mesh, s, 0.01)[1])


@pytest.mark.parametrize("k,n", [(0, 5), (27, 0)])
def test_no_voxel_or_no_candidate_is_no_call(k, n):
    best, bidx = torch.full((n,), 2.0), torch.full((n,), 9, dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]), trace.recording() as rec:
        out = fold.coupled_argmin_fold(torch.zeros((k, n)), torch.zeros((3, k)),
                                       torch.arange(k), torch.zeros((3, n)), 1.0, best, bidx)
    assert out[0] is best and out[1] is bidx
    assert torch.equal(best, torch.full((n,), 2.0)) and rec.counters == {}


# every (n, K^3) class of the benchmark's two cells, task 1's q = 8 and a
# tensor-parallel rank's slice
PLAN_CLASSES = [(983040, 125), (983040, 1331), (288320, 125), (288320, 343), (122880, 729),
                (122880, 2197), (62016, 125), (62016, 729), (1204224, 125), (1204224, 1331),
                (350464, 1331), (350464, 3375), (150528, 125), (150528, 343), (150528, 729),
                (73568, 729), (92160, 4913), (62016, 63)]


@pytest.mark.parametrize("n,k", PLAN_CLASSES)
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_plan_follows_the_shape(n, k, aligned):
    sms = 132  # an H100 SXM
    vec, splits = fold.launch_plan(n, k, aligned, sms)
    assert vec == (4 if aligned else 1) and splits in fold.SPLITS
    warps = -(-n // (32 * vec))
    target = fold.WARPS_PER_SM * sms
    # the fewest splits that reach the target, each range at least 32 candidates
    assert splits == 1 or warps * (splits // 2) < target
    assert splits == 1 or k >= 32 * splits
    assert splits == 8 or warps * splits >= target or k < 64 * splits


# ---------------------------------------------------------------------------
# csrc/convex.cu on the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_fold(tmp_path_factory):
    fn = build_host(tmp_path_factory.mktemp("convex_host"), "convex").coupled_argmin_fold
    P, I = ctypes.c_void_p, ctypes.c_int  # noqa: E741
    fn.argtypes = [P, ctypes.c_longlong, P, P, P, ctypes.c_float, P, P, I, I, I, I, P]
    fn.restype = I
    return fn


def _host_call(entry, vec, splits):
    def call(costs, mesh, idx, s, c, best, bidx):
        k, n = costs.shape
        mesh, idx, s = mesh.contiguous(), idx.contiguous(), s.contiguous()
        err = entry(costs.data_ptr(), costs.stride(0), mesh.data_ptr(), idx.data_ptr(),
                    s.data_ptr(), c, best.data_ptr(), bidx.data_ptr(), k, n, vec, splits, None)
        assert err == 0
        return best, bidx
    return call


@pytest.mark.parametrize("vec,splits", [(1, 1), (4, 1), (1, 2), (4, 4), (1, 8), (4, 8)])
def test_host_kernel_equals_plain_at_each_launch_shape(host_fold, vec, splits):
    """n = 203 (not a multiple of 4 or 32: a ragged warp and a masked
    float4), a dense fold and shuffled streamed blocks, ties and NaNs."""
    q, n = 2, 203
    costs, mesh, s = _case(q, n, seed=vec + splits, nan=4)
    call = _host_call(host_fold, vec, splits)
    for blocks in ([torch.arange(125)], _streamed_blocks(q)):
        order = np.random.default_rng(splits).permutation(len(blocks))
        got = _fold_blocks(call, costs, mesh, s, 0.03, blocks, order)
        want = _fold_blocks(fold.coupled_argmin_fold_plain, costs, mesh, s, 0.03, blocks, order)
        assert torch.equal(got[1], want[1]) and torch.equal(_bits(got[0]), _bits(want[0]))


def test_host_kernel_takes_row_strided_costs(host_fold):
    """Rows of a larger buffer, as a streamed block's rows of the owned
    slab and a rank's slice pass them: aligned (float4 loads with a row
    stride) and shifted by one float (scalar loads)."""
    q, n = 1, 72
    costs, mesh, s = _case(q, n, seed=11, nan=1)
    want = _fold_blocks(fold.coupled_argmin_fold_plain, costs, mesh, s, 1.0, [torch.arange(27)],
                        [0])
    for vec, off in ((4, 8), (1, 1)):
        buf = torch.full((27, n + 20), float("nan"))
        buf[:, off:off + n] = costs
        view = buf[:, off:off + n]
        best = torch.full((n,), float("inf"))
        bidx = torch.full((n,), 27, dtype=torch.int64)
        _host_call(host_fold, vec, 2)(view, mesh, torch.arange(27), s, 1.0, best, bidx)
        assert torch.equal(bidx, want[1]) and torch.equal(_bits(best), _bits(want[0]))


def test_host_kernel_keeps_a_running_minimum_across_splits_and_launches(host_fold):
    """Equal values in every candidate (c = 0 and equal costs): each split
    range and each launch ties, and the smallest index must win whichever
    block comes first; an incoming smaller value is kept."""
    k, n = 64, 40
    costs, mesh, s = torch.ones((k, n)), torch.zeros((3, k)), torch.zeros((3, n))
    best = torch.full((n,), float("inf"))
    bidx = torch.full((n,), k, dtype=torch.int64)
    best[:4] = 0.5
    call = _host_call(host_fold, 1, 8)
    for a in (48, 16, 0, 32):
        idx = torch.arange(a, a + 16)
        call(costs[idx], mesh[:, idx], idx, s, 0.0, best, bidx)
    assert torch.equal(bidx[4:], torch.zeros(n - 4, dtype=torch.int64))
    assert torch.equal(bidx[:4], torch.full((4,), k)) and torch.equal(best[:4], torch.full((4,), .5))


def test_host_entry_refuses_what_it_has_no_launch_for(host_fold):
    z = torch.zeros(4)
    for vec, splits, k, n in ((2, 1, 1, 1), (4, 3, 1, 1), (1, 16, 1, 1), (1, 1, 0, 1),
                              (1, 1, 1, 0)):
        err = host_fold(z.data_ptr(), 1, z.data_ptr(), z.data_ptr(), z.data_ptr(), 1.0,
                        z.data_ptr(), z.data_ptr(), k, n, vec, splits, None)
        assert err == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from convexadam_torch.kernels import _build
    _build.build_all(("convex",))
    return torch.device("cuda")


def _card_equal(costs, mesh, s, c, blocks, order):
    got = _fold_blocks(fold.coupled_argmin_fold, costs, mesh, s, c, blocks, order)
    want = _fold_blocks(fold.coupled_argmin_fold_plain, costs, mesh, s, c, blocks, order)
    return torch.equal(got[1], want[1]) and torch.equal(_bits(got[0]), _bits(want[0])), got


@pytest.mark.card
@pytest.mark.parametrize("q,n", [(2, 62016), (5, 150531), (7, 4099), (8, 9001)])
def test_card_kernel_equals_plain(q, n):
    """Dense and shuffled streamed blocks, ragged n, ties and NaNs; the
    dense fold also against ``torch.argmin`` on the card."""
    dev = _card()
    costs, mesh, s = (t.to(dev) for t in _case(q, n, seed=q, nan=9))
    for c in tconvex.COUPLING_COEFFS:
        for blocks in ([torch.arange(costs.shape[0])], _streamed_blocks(q)):
            order = np.random.default_rng(q).permutation(len(blocks))
            ok, got = _card_equal(costs, mesh, s, c, blocks, order)
            assert ok, (q, n, c, len(blocks))
            want_v, want_i = _whole(costs, mesh, s, c)
            assert torch.equal(got[1], want_i)


@pytest.mark.card
def test_card_kernel_takes_row_strided_costs():
    dev = _card()
    q, n = 3, 20480
    costs, mesh, s = (t.to(dev) for t in _case(q, n, seed=5, nan=3))
    k = costs.shape[0]
    want = _fold_blocks(fold.coupled_argmin_fold_plain, costs, mesh, s, 0.1, [torch.arange(k)],
                        [0])
    for off in (8, 1):  # float4 loads with a row stride; scalar loads
        buf = torch.full((k, n + 40), float("nan"), device=dev)
        buf[:, off:off + n] = costs
        best = torch.full((n,), float("inf"), device=dev)
        bidx = torch.full((n,), k, dtype=torch.int64, device=dev)
        fold.coupled_argmin_fold(buf[:, off:off + n], mesh, torch.arange(k, device=dev), s, 0.1,
                                 best, bidx)
        assert torch.equal(bidx, want[1]) and torch.equal(_bits(best), _bits(want[0]))


def _semantic_features(dev, n=40, seed=0):
    """One-hot features (4 channels) of two boxes, pooled by 2."""
    rng = np.random.default_rng(seed)
    segs = []
    for o in rng.integers(-3, 4, (2, 3)):
        seg = np.zeros((n, n, n), np.int64)
        seg[8 + o[0]:30 + o[0], 6 + o[1]:28 + o[1], 9 + o[2]:31 + o[2]] = 1
        seg[14 + o[0]:22 + o[0], 12 + o[1]:20 + o[1], 15 + o[2]:25 + o[2]] = 2
        seg[4:9, 30:36, 5 + abs(o[2]):12] = 3
        segs.append(seg)
    oh = [torch.nn.functional.one_hot(torch.from_numpy(s), 4).permute(3, 0, 1, 2).float()
          for s in segs]
    return [torch.nn.functional.avg_pool3d(x[None], 2)[0].to(dev).contiguous() for x in oh]


@pytest.mark.card
@pytest.mark.parametrize("rounds", range(1, 7))
def test_card_dense_streamed_tp_and_plain_fields_are_equal(rounds, monkeypatch):
    """After each of the six couplings (the coefficients cut to the first
    ``rounds``): the dense, streamed and tensor-parallel fields and the
    dense path with the plain fold, to the bit."""
    dev = _card()
    fix, mov = _semantic_features(dev)
    q = 3
    monkeypatch.setattr(tconvex, "COUPLING_COEFFS", tconvex.COUPLING_COEFFS[:rounds])
    with torch.no_grad():
        dense = tconvex.convex_displacement(fix, mov, q)
        streamed = tconvex.convex_displacement(fix, mov, q, stream_threshold=0)
        tp = tconvex.convex_displacement_tp(fix, mov, q)
        monkeypatch.setattr(tconvex, "coupled_argmin_fold", fold.coupled_argmin_fold_plain)
        plain = tconvex.convex_displacement(fix, mov, q)
    for other in (streamed, tp, plain):
        assert torch.equal(dense, other)
