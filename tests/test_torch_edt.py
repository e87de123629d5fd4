"""The port's HD95 engine and its search kernels against the JAX package.

The three plain search versions (``convexadam_torch/kernels/edt.py``), which
the wrappers run for CPU tensors and which ``chip_smoke.py`` holds the CUDA
kernels against on the card, are held against the Pallas kernels they
replace, run in interpret mode as ``tests/test_edt.py`` runs them.  The
engine (``convexadam_torch/core/edt.py``) is held against the JAX functions
and the host EDT loop.  Inputs are made from a seed with numpy.

Squared distances between integer points below 1024 are exact in float32,
so the searches are compared for equality at their meaningful entries (the
entries outside them are not meaningful in either package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

import convexadam_torch.core.edt as tedt
from convexadam_torch.kernels import LAUNCHES
from convexadam_torch.kernels.edt import (
    ACC_INIT,
    COORD_PAD,
    PRUNED_BLOCK,
    PRUNED_TILE,
    nearest_sq,
    nearest_sq_dual,
    nearest_sq_plain,
    nearest_sq_pruned,
    nearest_sq_pruned_batched,
    pruned_block_order,
)
from convexadam_torch.core.metrics import hd95 as host_hd95

torch.set_num_threads(2)


def _points(rng, K, n, extent=40):
    """(3, K) float32: ``n`` distinct integer points of an ``extent``³ grid
    in raster order (as surface buffers are), then pads."""
    flat = np.sort(rng.choice(extent ** 3, size=n, replace=False))
    pts = np.full((3, K), COORD_PAD, np.float32)
    pts[:, :n] = np.stack(np.unravel_index(flat, (extent,) * 3)).astype(np.float32)
    return pts


# K, n_query, n_target, head_query, head_target, q_lo, q_hi
_CASES = {
    256: (200, 180, 70, 90, 30, 190),
    512: (450, 300, 260, 100, 100, 430),
}


# the tiled search in the engine's roles: Kq, Kt, real query points,
# n_query, real target points, n_target, the Pallas target block (None: its
# own choice).  The engine's n_query is the head of the surface that lies
# inside the other mask, so real points follow it
_TILED = {
    "256": (256, 256, 200, 200, 180, 180, None),
    "512": (512, 512, 450, 450, 300, 300, None),
    "head of the surface": (512, 512, 450, 260, 300, 300, None),
    "no live query": (256, 256, 200, 0, 180, 180, None),
    "no live target": (256, 256, 200, 200, 180, 0, None),
    "Kt 1000": (256, 1000, 200, 200, 937, 937, None),
    "Kt 2600": (256, 2600, 200, 170, 2411, 2411, 1300),
}


@pytest.mark.parametrize("case", list(_TILED))
def test_nearest_sq_plain_matches_pallas(rng, case):
    """The meaningful entries equal the Pallas kernel's (interpret mode);
    every query at or past n_query holds ACC_INIT, which the CUDA kernel's
    atomicMin merge keeps from the wrapper's fill."""
    from convexadam_tpu.ops.edt_pallas import nearest_sq_pallas

    kq, kt, real_q, nq, real_t, nt, bt = _TILED[case]
    q, t = _points(rng, kq, real_q), _points(rng, kt, real_t)
    ref = np.asarray(nearest_sq_pallas(jnp.asarray(q), jnp.asarray(t), jnp.int32(nq),
                                       jnp.int32(nt), interpret=True, bt=bt))
    out = nearest_sq(torch.from_numpy(q), torch.from_numpy(t), nq, nt).numpy()
    np.testing.assert_array_equal(out[:nq], ref[:nq])
    np.testing.assert_array_equal(out[nq:], np.full(kq - nq, ACC_INIT, np.float32))
    if nt == 0:
        assert bool((out == ACC_INIT).all())


@pytest.mark.parametrize("K", [256, 512])
def test_nearest_sq_dual_plain_matches_pallas(rng, K):
    from convexadam_tpu.ops.edt_pallas import nearest_sq_dual_pallas

    nq, nt, hq, ht = _CASES[K][:4]
    q, t = _points(rng, K, nq), _points(rng, K, nt)
    rq, rt = nearest_sq_dual_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.int32(nq), jnp.int32(nt), jnp.int32(hq),
        jnp.int32(ht), interpret=True,
    )
    oq, ot = nearest_sq_dual(torch.from_numpy(q), torch.from_numpy(t), nq, nt, hq, ht)
    np.testing.assert_array_equal(oq.numpy()[hq:nq], np.asarray(rq)[hq:nq])
    np.testing.assert_array_equal(ot.numpy()[ht:nt], np.asarray(rt)[ht:nt])


@pytest.mark.parametrize("block", [None, 128])
@pytest.mark.parametrize("K", [256, 512])
def test_nearest_sq_pruned_plain_matches_pallas(rng, K, block):
    from convexadam_tpu.ops.edt_pallas import nearest_sq_pruned_pallas

    nq, nt, _, _, lo, hi = _CASES[K]
    q, t = _points(rng, K, nq, extent=24), _points(rng, K, nt, extent=24)
    ref = np.asarray(nearest_sq_pruned_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.int32(lo), jnp.int32(hi), jnp.int32(nt),
        interpret=True, bq=block, bt=block,
    ))
    out, tiles = nearest_sq_pruned(torch.from_numpy(q), torch.from_numpy(t), lo, hi, nt,
                                   with_tiles=True)
    np.testing.assert_array_equal(out.numpy()[lo:hi], ref[lo:hi])
    gi = -(-K // PRUNED_BLOCK)
    assert tiles.shape == (gi,) and int(tiles.max()) <= gi


def test_pruned_ragged_equals_tiled_and_prunes(rng):
    """A ragged case (K and n not multiples of the block): the pruned search
    equals the full search at its meaningful entries, visits no tile past
    n_target and skips most tiles of well-separated raster slabs."""
    K, n, lo, hi = 1000, 937, 5, 901
    q, t = _points(rng, K, n, extent=64), _points(rng, K, n, extent=64)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    full = nearest_sq_plain(qt, tt, K, n).numpy()
    out, tiles = nearest_sq_pruned(qt, tt, lo, hi, n, with_tiles=True)
    np.testing.assert_array_equal(out.numpy()[lo:hi], full[lo:hi])
    order, dsort = pruned_block_order(qt, tt, n)
    gi, gj = order.shape
    # K padded to 1024: query blocks of 32, target tiles of 128
    assert (gi, gj) == (1024 // PRUNED_BLOCK, 1024 // PRUNED_TILE) == (32, 8)
    live_tiles = -(-n // PRUNED_TILE)
    assert int(tiles.max()) <= live_tiles
    assert int(tiles.sum()) < gi * live_tiles
    assert bool((dsort[:, live_tiles:] == 3.0e38).all())


# per layout: the query sets' counts, the target sets' counts, and the
# searches (query set, target set, q_lo, q_hi, n_target): mixed counts, an
# empty query range, a search without live targets.  n_target is a set's
# count or 0: past it a buffer holds pads, as the engine's buffers do (the
# Pallas kernel reads every point of a live tile)
_BATCHES = {
    # K = 512 on the Pallas side, 512-point slots in the buffers
    "aligned": (512, (450, 300), (260, 500, 37), (
        (0, 0, 100, 430, 260), (0, 1, 0, 450, 500), (1, 2, 10, 290, 37),
        (1, 0, 200, 200, 260), (0, 2, 449, 450, 0), (1, 1, 0, 300, 500),
    )),
    # ragged K = 300 on the Pallas side, in 384-point slots
    "ragged": (300, (280, 250), (260, 299, 37), (
        (0, 0, 17, 280, 260), (1, 1, 0, 250, 299), (0, 2, 3, 277, 37),
        (1, 0, 120, 120, 260), (1, 2, 0, 1, 0), (0, 1, 250, 279, 299),
    )),
}


def _batch(rng, layout):
    """The point sets of a layout (numpy, as the Pallas side takes them) and
    the same sets in two buffers of whole-tile slots, with the batched
    call's arguments."""
    K, nqs, nts, rows = _BATCHES[layout]
    slot = -(-K // PRUNED_TILE) * PRUNED_TILE
    qsets = [_points(rng, K, n, extent=24) for n in nqs]
    tsets = [_points(rng, K, n, extent=24) for n in nts]

    def buffer(sets):
        buf = np.full((3, slot * len(sets)), COORD_PAD, np.float32)
        for k, pts in enumerate(sets):
            buf[:, k * slot:k * slot + K] = pts
        return torch.from_numpy(buf)

    searches = [(0, qi * slot, 1, ti * slot) for qi, ti, _, _, _ in rows]
    counts = [torch.tensor([r[c] for r in rows], dtype=torch.int32) for c in (2, 3, 4)]
    return qsets, tsets, rows, ([buffer(qsets), buffer(tsets)], searches, *counts, slot, slot)


@pytest.mark.parametrize("layout", ["aligned", "ragged"])
def test_pruned_batched_plain_matches_pallas(rng, layout):
    """Six searches of mixed counts in one batched call, read in place from
    two buffers, each equal to ``nearest_sq_pruned_pallas`` (interpret mode)
    on its own sets at the meaningful entries."""
    from convexadam_tpu.ops.edt_pallas import nearest_sq_pruned_pallas

    qsets, tsets, rows, args = _batch(rng, layout)
    out, tiles = nearest_sq_pruned_batched(*args, with_tiles=True)
    assert out.shape == (len(rows), args[-2]) and tiles.shape == (len(rows), args[-2] // PRUNED_BLOCK)
    for s, (qi, ti, lo, hi, nt) in enumerate(rows):
        ref = np.asarray(nearest_sq_pruned_pallas(
            jnp.asarray(qsets[qi]), jnp.asarray(tsets[ti]), jnp.int32(lo), jnp.int32(hi),
            jnp.int32(nt), interpret=True,
        ))
        np.testing.assert_array_equal(out[s].numpy()[lo:hi], ref[lo:hi], err_msg=f"search {s}")
        if hi <= lo or nt == 0:
            assert int(tiles[s].sum()) == 0


@pytest.mark.parametrize("layout", ["aligned", "ragged"])
def test_pruned_batched_equals_single_searches(rng, layout):
    """Batching changes no walk: each search of the batch, and the batch of
    one, equal the single-search entry on that search's own copies, tiles
    included."""
    qsets, tsets, rows, args = _batch(rng, layout)
    out, tiles = nearest_sq_pruned_batched(*args, with_tiles=True)
    for s, (qi, ti, lo, hi, nt) in enumerate(rows):
        q, t = torch.from_numpy(qsets[qi]), torch.from_numpy(tsets[ti])
        one, one_tiles = nearest_sq_pruned(q, t, lo, hi, nt, with_tiles=True)
        K = q.shape[1]
        np.testing.assert_array_equal(out[s, :K].numpy()[lo:hi], one.numpy()[lo:hi])
        np.testing.assert_array_equal(tiles[s, :one_tiles.shape[0]].numpy(), one_tiles.numpy())
        (sources, searches, *counts, kq, kt) = args
        b_out, b_tiles = nearest_sq_pruned_batched(
            sources, searches[s:s + 1], *(c[s:s + 1] for c in counts), kq, kt, with_tiles=True)
        np.testing.assert_array_equal(b_out[0].numpy(), out[s].numpy())
        np.testing.assert_array_equal(b_tiles[0].numpy(), tiles[s].numpy())


def test_pruned_batched_parts_and_launches_agree(rng, monkeypatch):
    """Order tables cut into row parts and several launches (a tiny table
    limit) give the same minima and tiles as one launch."""
    import convexadam_torch.kernels.edt as ke

    _, _, _, args = _batch(rng, "aligned")
    out, tiles = nearest_sq_pruned_batched(*args, with_tiles=True)
    monkeypatch.setattr(ke, "PRUNED_TABLE_ENTRIES", 2 * 512 // PRUNED_TILE)
    plan = ke._pruned_plan(*args)
    assert plan.parts == 512 // PRUNED_BLOCK // 2 and len(plan.launches) == plan.table.shape[0]
    cut, cut_tiles = nearest_sq_pruned_batched(*args, with_tiles=True)
    np.testing.assert_array_equal(cut.numpy(), out.numpy())
    np.testing.assert_array_equal(cut_tiles.numpy(), tiles.numpy())


def test_pruned_batched_refuses_unaligned_searches(rng):
    q = torch.from_numpy(_points(rng, 256, 100))
    with pytest.raises(ValueError, match="aligned"):
        nearest_sq_pruned_batched([q], [(0, 64, 0, 0)], 0, 100, 100, 128, 128)
    with pytest.raises(ValueError, match="multiples"):
        nearest_sq_pruned_batched([q], [(0, 0, 0, 0)], 0, 100, 100, 200, 256)


def test_cpu_search_wrappers_launch_nothing(rng):
    before = dict(LAUNCHES)
    q = torch.from_numpy(_points(rng, 256, 100))
    nearest_sq(q, q, 100, 100)
    nearest_sq_dual(q, q, 100, 100, 10, 10)
    nearest_sq_pruned(q, q, 0, 100, 100)
    assert LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["tiled", "dual", "pruned"])
def test_search_wrappers_refuse_other_devices(wrapper):
    m = torch.empty((3, 256), device="meta")
    calls = {
        "tiled": lambda: nearest_sq(m, m, 1, 1),
        "dual": lambda: nearest_sq_dual(m, m, 1, 1, 0, 0),
        "pruned": lambda: nearest_sq_pruned(m, m, 0, 1, 1),
    }
    with pytest.raises(ValueError, match="CPU or CUDA"):
        calls[wrapper]()


@pytest.mark.parametrize("K", [50, 500])
def test_compact_matches_jax(rng, K):
    from convexadam_tpu.core.edt import _compact

    mask = rng.random(400) < 0.4
    ref_buf, ref_n = _compact(jnp.asarray(mask), K)
    buf, n = tedt._compact(torch.from_numpy(mask), K)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))
    assert int(n) == int(ref_n)


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _assert_same(port, ref):
    p, r = _fields(port), _fields(ref)
    assert p.keys() == r.keys()
    for k in p:
        np.testing.assert_array_equal(np.asarray(p[k]), r[k], err_msg=k)


@pytest.mark.parametrize("L,caps_for", [(3, "packed"), (20, "unpacked")])
def test_surface_lists_and_label_buffers_match_jax(rng, L, caps_for):
    """Both surface-list paths (the packed word for <= 14 labels, the
    separate gathers beyond, as with OASIS's 35 labels) and the label
    buffers, including a truncating cap, equal the JAX package's."""
    from convexadam_tpu.core.edt import label_buffers, surface_lists

    shape = (9, 10, 11)
    s1 = rng.integers(0, L + 1, shape).astype(np.int32)
    s2 = rng.integers(0, L + 1, shape).astype(np.int32)
    pre_j = surface_lists(jnp.asarray(s1), jnp.asarray(s2), L)
    pre_t = tedt.surface_lists(torch.from_numpy(s1), torch.from_numpy(s2), L)
    _assert_same(pre_t, pre_j)
    caps = [0] + [48] * L
    caps[2] = 5  # label 2 truncated
    caps = tuple(caps)
    _assert_same(tedt.label_buffers(pre_t, L, caps), label_buffers(pre_j, L, caps))


def test_inside_flags_match_jax(rng):
    from convexadam_tpu.core.edt import inside_flags, surface_side

    s1 = rng.integers(0, 4, (8, 9, 10)).astype(np.int32)
    s2 = rng.integers(0, 4, (8, 9, 10)).astype(np.int32)
    side_j = surface_side(jnp.asarray(s1), 3)
    side_t = tedt.surface_side(torch.from_numpy(s1), 3)
    _assert_same(side_t, side_j)
    np.testing.assert_array_equal(
        tedt.inside_flags(side_t, torch.from_numpy(s1), torch.from_numpy(s2)).numpy(),
        np.asarray(inside_flags(side_j, jnp.asarray(s1), jnp.asarray(s2))),
    )


@pytest.mark.parametrize("case", ["generous", "tiny", "small_global"])
def test_caps_overflow_matches_jax(rng, case):
    from convexadam_tpu.core.edt import caps_overflow, label_buffers, surface_lists

    s1 = rng.integers(0, 3, (12, 12, 12)).astype(np.int32)
    s2 = rng.integers(0, 3, (12, 12, 12)).astype(np.int32)
    caps = (0, 8, 8) if case == "tiny" else (0, 2048, 2048)
    glob = 64 if case == "small_global" else None
    pre_j = surface_lists(jnp.asarray(s1), jnp.asarray(s2), 2, glob)
    ref = bool(caps_overflow(pre_j, label_buffers(pre_j, 2, caps), caps))
    pre_t = tedt.surface_lists(torch.from_numpy(s1), torch.from_numpy(s2), 2, glob)
    got = bool(tedt.caps_overflow(pre_t, tedt.label_buffers(pre_t, 2, caps), caps))
    assert got == ref == (case != "generous")


def _sheet_pair(rng):
    """Two random 2-label volumes with a 1-voxel-thick sheet of label 3,
    whose outer shell exceeds its inner surface (``tests/test_edt.py``)."""
    s1 = rng.integers(0, 3, (16, 18, 20)).astype(np.int32)
    s2 = rng.integers(0, 3, (16, 18, 20)).astype(np.int32)
    s1[8, 2:16, 2:18] = 3
    s2[9, 2:16, 2:18] = 3
    return s1, s2


def _smooth_labels(seed, shape=(18, 20, 22), q=(0.3, 0.6, 0.85)):
    v = uniform_filter(np.random.default_rng(seed).standard_normal(shape).astype(np.float32), 5)
    return np.digitize(v, np.quantile(v, q)).astype(np.int32)


@pytest.mark.parametrize("L", [3, 20])
def test_suggest_hd95_caps_matches_jax(rng, L):
    from convexadam_tpu.core.edt import suggest_hd95_caps

    if L == 3:
        s1, s2 = _sheet_pair(rng)
    else:
        s1 = rng.integers(0, L + 1, (20, 24, 28)).astype(np.int32)
        s2 = rng.integers(0, L + 1, (20, 24, 28)).astype(np.int32)
    assert tedt.suggest_hd95_caps(s1, s2, L) == suggest_hd95_caps(s1, s2, L)


@pytest.mark.parametrize("missing", [False, True])
def test_hd95_device_sized_matches_jax_and_host(rng, missing):
    """The sheet case of ``tests/test_edt.py``; with ``missing`` label 2 is
    removed from the moving volume and scores 30."""
    from convexadam_tpu.core.edt import hd95_device_sized

    s1, s2 = _sheet_pair(rng)
    if missing:
        s2[s2 == 2] = 1
    got = tedt.hd95_device_sized(s1, s2, 3, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(hd95_device_sized(s1, s2, 3)), atol=1e-5)
    np.testing.assert_allclose(got, host_hd95(s1, s2, 3), atol=1e-5)
    assert (got[1] == 30.0) == missing


@pytest.mark.parametrize("max_surface", [None, 4096])
def test_hd95_device_matches_jax_and_host(max_surface):
    """``max_surface=None`` takes K = |volume| (not a multiple of 128: the
    dual and tiled searches), 4096 the pruned search; label 3 removed from
    one volume scores 30."""
    from convexadam_tpu.core.edt import hd95_device

    s1, s2 = _smooth_labels(0), _smooth_labels(1)
    for a, b in ((s1, s2), (np.where(s1 == 3, 2, s1), s2)):
        got = tedt.hd95_device(torch.from_numpy(a), torch.from_numpy(b), 3,
                               max_surface=max_surface, device="cpu").numpy()
        ref = np.asarray(hd95_device(jnp.asarray(a), jnp.asarray(b), 3, max_surface=max_surface))
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got, host_hd95(a, b, 3), atol=1e-5)
    assert got[2] == 30.0


def _two_bucket_pair():
    """A large sphere (K = 8192 bucket) and two small ones (K = 4096),
    moving = fixed rolled by (1, -2, 1)."""
    zz, yy, xx = np.ogrid[:50, :50, :50]
    s = np.zeros((50, 50, 50), np.int32)
    s[((zz - 24) ** 2 + (yy - 25) ** 2 + (xx - 24) ** 2) <= 21 ** 2] = 1
    s[((zz - 5) ** 2 + (yy - 5) ** 2 + (xx - 44) ** 2) <= 4 ** 2] = 2
    s[((zz - 44) ** 2 + (yy - 44) ** 2 + (xx - 5) ** 2) <= 3 ** 2] = 3
    return s, np.roll(s, (1, -2, 1), axis=(0, 1, 2))


def test_hd95_two_buckets_match_jax_exactly(monkeypatch):
    """Each bucket's searches in one batched call and one sort: the HD95 of
    a pair with two label buckets equals the JAX package's bit for bit, and
    the host EDT loop's; each bucket is one call of the batched search."""
    import convexadam_torch.kernels.edt as ke
    from convexadam_tpu.core.edt import hd95_device_sized

    s1, s2 = _two_bucket_pair()
    groups, _ = tedt.suggest_hd95_caps(s1, s2, 3)
    assert groups == (((2, 3), 4096), ((1,), 8192))
    calls = []
    batched = ke.nearest_sq_pruned_batched
    monkeypatch.setattr(tedt, "nearest_sq_pruned_batched",
                        lambda *a, **k: calls.append(len(a[1])) or batched(*a, **k))
    got = tedt.hd95_device_sized(s1, s2, 3, device="cpu").numpy()
    assert calls == [8, 4]
    np.testing.assert_array_equal(got, np.asarray(hd95_device_sized(s1, s2, 3)))
    np.testing.assert_allclose(got, host_hd95(s1, s2, 3), atol=1e-5)


@pytest.mark.parametrize("entry", ["hd95_device", "hd95_device_sized"])
def test_hd95_entries_default_to_cuda(monkeypatch, entry):
    """As every entry of the port: a CPU tensor without ``device="cpu"``
    still asks for the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = torch.zeros((8, 8, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tedt, entry)(seg, seg, 1)


def test_hd95_branches_agree(monkeypatch):
    """The pruned and the dual + tiled branches give identical HD95."""
    s1, s2 = _smooth_labels(2, q=(0.2, 0.4, 0.6, 0.8)), _smooth_labels(3, q=(0.2, 0.4, 0.6, 0.8))
    pruned = tedt.hd95_device_sized(s1, s2, 4, device="cpu").numpy()
    monkeypatch.setattr(tedt, "_pruned_search_enabled", lambda K: False)
    tiled = tedt.hd95_device_sized(s1, s2, 4, device="cpu").numpy()
    np.testing.assert_array_equal(pruned, tiled)
    np.testing.assert_allclose(pruned, host_hd95(s1, s2, 4), atol=1e-5)


def test_pruned_search_threshold_is_the_measured_one():
    """The pruned search runs at every K that is a multiple of its tile up
    to 1048576, the largest K measured on the card; the JAX package stops at
    its VMEM limit, 524288.  The packing limit is the JAX package's."""
    from convexadam_tpu.core import edt as jedt

    for K, want in ((4096, True), (65536, True), (524288, True), (1 << 20, True),
                    (1 << 21, False), (1000, False)):
        assert tedt._pruned_search_enabled(K) == want, K
    assert jedt._pruned_search_enabled(1 << 20) is False  # where the two packages differ
    assert tedt.MAX_PACKED_EXTENT == jedt.MAX_PACKED_EXTENT


def test_surface_side_rejects_large_extent():
    with pytest.raises(ValueError, match="dims <= 1024"):
        tedt.surface_side(torch.zeros((1025, 1, 1), dtype=torch.int32), 1)


def test_percentile_matches_numpy(rng):
    vals = np.sort(rng.random(40).astype(np.float32))
    for n in (1, 2, 17, 40):
        padded = np.concatenate([vals[:n], np.full(40 - n, np.inf, np.float32)])
        got = tedt._percentile_sorted(torch.from_numpy(padded), torch.tensor(n), 95.0)
        np.testing.assert_allclose(float(got), np.percentile(vals[:n], 95), rtol=1e-6)
