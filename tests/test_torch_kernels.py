"""The port's plain kernel versions against the JAX package's Pallas kernels.

Each plain version (``convexadam_torch/kernels/*.py``) is what a kernel
wrapper runs for CPU tensors and what ``chip_smoke.py`` holds the CUDA
kernel against on the card.  Here it is held against the Pallas kernel it
replaces, run in interpret mode on the CPU as ``tests/test_pallas_ops.py``
runs it, at shapes the Pallas guards accept.  Inputs are made from a seed
with numpy and handed to both.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convexadam_tpu.core.warp import build_corner_stack
from convexadam_tpu.ops.cost_volume_pallas import cost_volume_pallas
from convexadam_tpu.ops.mind_pallas import mind_ssd_stats_pallas, mind_supported
from convexadam_tpu.ops.warp_pallas import corner_reduce_fwd, corner_reduce_loss_grad
from convexadam_torch.core.warp import identity_grid_normalized
from convexadam_torch.kernels import LAUNCHES
from convexadam_torch.kernels.cost_volume import COMPILED_Q, cost_volume, kernel_for
import convexadam_torch.kernels.mind as kmind
from convexadam_torch.kernels.mind import (
    COMPILED_PAIRS,
    SMEM_PER_BLOCK,
    TILE,
    _pair_offsets,
    general_plan,
    kernel_for as mind_kernel_for,
    mind_ssd_stats,
)
from convexadam_torch.kernels.warp import (
    inverse_consistency_steps,
    inverse_consistency_steps_plain,
    sample_trilinear,
    sample_trilinear_bwd,
    sample_trilinear_plain,
    warp_ssd_loss_grad,
)

torch.set_num_threads(2)


MIND_PAIRS = [(r, d) for r in (1, 2, 3) for d in (1, 2, 3)]  # the search's radii and dilations
# pairs the general kernel runs on the card: a radius or a dilation of 0, a
# dilation of 5 or 7 (whose old dispatch key r * 4 + d fell on a compiled
# pair's), radius 4, and a halo past the kernel's shared memory
MIND_GENERAL_PAIRS = [(0, 2), (1, 5), (2, 7), (4, 1), (1, 12)]


def _mind_source() -> str:
    return (pathlib.Path(__file__).resolve().parent.parent / "convexadam_torch" / "csrc"
            / "mind.cu").read_text()


def _mind_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _mind_source()).group(1))


@pytest.mark.parametrize("r,d,dtype",
                         [(r, d, "float32") for r, d in MIND_PAIRS + MIND_GENERAL_PAIRS]
                         + [(1, 2, "bfloat16"), (4, 1, "bfloat16")])
def test_mind_ssd_stats_matches_pallas(rng, monkeypatch, r, d, dtype):
    shape = (16, 16, 20)
    assert mind_supported(shape, r, d, 2 if dtype == "bfloat16" else 4)
    x = rng.standard_normal(shape).astype(np.float32)
    mind_p, var_p = mind_ssd_stats_pallas(jnp.asarray(x).astype(dtype), r, d, interpret=True)
    mind_t, var_t = mind_ssd_stats(torch.from_numpy(x).to(getattr(torch, dtype)), r, d)
    assert mind_t.dtype == getattr(torch, dtype) and var_t.dtype == torch.float32
    mind_p = np.asarray(mind_p.astype(jnp.float32))
    if dtype == "float32":
        # same operations in the same order; the box divisor and the channel
        # mean are true divisions here, a multiply by the reciprocal in XLA
        np.testing.assert_allclose(mind_t.numpy(), mind_p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_p), rtol=1e-5, atol=1e-6)
    else:
        # bf16: mind equal to the bit; where bf16 cannot hold k^3 (729 at
        # r = 4) the Pallas kernel divides by k^3 rounded to bf16, as
        # test_mind_bf16_pallas_divides_by_bf16_343 shows at r = 3, so the
        # plain version is held to it with that divisor.  The Pallas
        # kernel's var adds the channels' differences before XLA rounds them
        # to bf16 (excess precision), so within 2^-7 relative (one or two
        # bf16 ulps)
        k3 = float((2 * r + 1) ** 3)
        k3_bf16 = float(torch.tensor(k3).to(torch.bfloat16))
        if k3_bf16 != k3:
            true_div = kmind._true_div
            monkeypatch.setattr(kmind, "_true_div",
                                lambda t, v: true_div(t, k3_bf16 if v == k3 else v))
            mind_t, var_t = mind_ssd_stats(torch.from_numpy(x).to(torch.bfloat16), r, d)
        np.testing.assert_array_equal(mind_t.float().numpy(), mind_p)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_p), rtol=2.0**-7)


def test_mind_kernel_choice_covers_every_pair():
    """The wrapper's choice by (r, d): the compiled kernel for exactly the
    search's {1, 2, 3}^2, the general kernel for every other pair."""
    assert COMPILED_PAIRS == set(MIND_PAIRS)
    for r in range(17):
        for d in range(17):
            want = "mind_kernel" if (r, d) in COMPILED_PAIRS else "mind_general_kernel"
            assert mind_kernel_for(r, d) == want, (r, d)


def test_mind_dispatch_launches_each_pair_its_own_instance():
    """The C dispatch tests r and dil each on their own: every compiled case
    launches ``launch_fixed<T, R, DIL>`` for its own (R, DIL), one case a
    pair of {1, 2, 3}^2, and ``general`` routes to the general kernel.  (A
    key such as r * 4 + dil gives pairs with dil >= 4 a compiled pair's
    case.)"""
    src = _mind_source()
    entry = src[src.index("int launch(const void* x"):]
    entry = entry[:entry.index("\n}\n")]
    cases = re.findall(
        r"if \(r == (\d+) && dil == (\d+)\) return launch_fixed<T, (\d+), (\d+)>\(", entry)
    assert sorted((int(a), int(b)) for a, b, _, _ in cases) == sorted(MIND_PAIRS)
    assert all((a, b) == (c, e) for a, b, c, e in cases)
    assert len(re.findall(r"launch_fixed<", entry)) == len(MIND_PAIRS)
    assert "if (general) return launch_general<T>(" in entry
    assert "switch" not in entry


@pytest.mark.parametrize("r,d", [(-1, 2), (1, -2)])
def test_mind_ssd_stats_refuses_negative_pairs(r, d):
    with pytest.raises(ValueError, match=">= 0"):
        mind_ssd_stats(torch.zeros((4, 4, 4)), r, d)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_mind_general_plan_fits_shared_memory(itemsize):
    """The general kernel's staging for every (r, d) up to 40 x 40 and a few
    large radii: shared memory within a CTA's, the image halo staged where
    it fits ((4, 1) among them) and otherwise the H sums in W chunks of at
    least one column; a radius whose W sums alone outgrow a CTA's shared
    memory is refused; the tile is the source's."""
    assert TILE == tuple(_mind_constant(n) for n in ("FH", "FW", "FD"))
    fh, fw, fd = TILE
    for r in list(range(41)) + [100, 300, 400]:
        for d in range(41):
            halo, cw, nbytes = general_plan(r, d, itemsize)
            assert nbytes <= SMEM_PER_BLOCK and 1 <= cw <= fw + 2 * r
            assert not halo or cw == fw + 2 * r
    assert general_plan(4, 1, itemsize)[0] and not general_plan(1, 12, itemsize)[0]
    assert general_plan(100, 3, itemsize)[1] < fw + 200  # chunked
    with pytest.raises(ValueError, match="shared memory"):
        general_plan(2000, 1, itemsize)


@pytest.mark.parametrize("r", range(12))
def test_mind_general_kernel_adds_every_window_in_order(r):
    """The general kernel's order of additions, replayed from its loops: the
    H sums streamed row by row (``2r + 1 >= FH``: a head, a middle and a
    tail of rows; else every row with a test per plane) give plane h the
    rows h .. h + 2r in ascending order, and the W sums taken over chunks of
    columns give column w the columns w .. w + 2r in ascending order, for
    any chunk width."""
    fh, fw, _ = TILE
    rows = {h: [] for h in range(fh)}
    if 2 * r + 1 >= fh:
        order = ([(i, range(i + 1)) for i in range(fh - 1)]
                 + [(i, range(fh)) for i in range(fh - 1, 2 * r + 1)]
                 + [(2 * r + j, range(j, fh)) for j in range(1, fh)])
    else:
        order = [(i, [h for h in range(fh) if 0 <= i - h <= 2 * r]) for i in range(fh + 2 * r)]
    for i, planes in order:
        for h in planes:
            rows[h].append(i)
    assert all(rows[h] == list(range(h, h + 2 * r + 1)) for h in range(fh))
    ew = fw + 2 * r
    for cw in sorted({ew, max(1, ew // 3), 1}):
        cols = {w: [] for w in range(fw)}
        for c0 in range(0, ew, cw):
            ncol = min(cw, ew - c0)
            for w in range(fw):
                cols[w] += [w + j for j in range(max(0, c0 - w), min(2 * r, c0 + ncol - 1 - w) + 1)]
        assert all(cols[w] == list(range(w, w + 2 * r + 1)) for w in range(fw))


def test_mind_bf16_pallas_divides_by_bf16_343(rng, monkeypatch):
    """At radius 3 in bf16 the Pallas kernel divides the box sums by k^3 =
    343 rounded to bf16, 344 (``acc3 / float(k**3)`` on a bf16 tile); the
    port divides by 343 exactly.  With the divisor 344 the plain version
    equals the Pallas kernel to the bit, so that is the only difference."""
    x = rng.standard_normal((16, 16, 20)).astype(np.float32)
    mind_p, _ = mind_ssd_stats_pallas(jnp.asarray(x).astype("bfloat16"), 3, 1, interpret=True)
    mind_p = np.asarray(mind_p.astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    exact = kmind.mind_ssd_stats_plain(xt, 3, 1)[0].float().numpy()
    true_div = kmind._true_div
    monkeypatch.setattr(kmind, "_true_div", lambda t, v: true_div(t, 344.0 if v == 343.0 else v))
    as_pallas = kmind.mind_ssd_stats_plain(xt, 3, 1)[0].float().numpy()
    np.testing.assert_array_equal(as_pallas, mind_p)
    assert not np.array_equal(exact, mind_p)


def test_mind_kernel_pair_table_matches_shift_pairs():
    """The MIND kernels' table of the 12 shift pairs
    (``csrc/mind.cu:pair_code``, each shift coded (oh+1)*9 + (ow+1)*3 +
    (od+1)) is the plain version's ``_pair_offsets``, pair by pair."""
    src = _mind_source()
    body = src[src.index("pair_code(int c)"):]
    body = body[: body.index("}\n}")]
    codes = [tuple(map(int, m)) for m in re.findall(r"return (\d+) \* 27 \+ (\d+);", body)]

    def offset(code):
        return (code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1)

    assert [(offset(a), offset(b)) for a, b in codes] == _pair_offsets(1)


@pytest.mark.parametrize("r", range(10))
def test_mind_bf16_mean_by_reciprocal_equals_true_division(r):
    """The MIND kernels' bf16 box mean multiplies the sum by the float
    reciprocal of k^3 (``csrc/mind.cu``, ``Pair<__nv_bfloat16>::mean``): the
    compiled kernels at r = 1, 2, 3, the general kernel up to
    ``RECIP_MAX_R`` (9); the plain version divides.  For every finite bf16
    sum, subnormals included, both round to the same bf16."""
    assert r <= _mind_constant("RECIP_MAX_R") == 9
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    a = bits[torch.isfinite(bits)]
    k3 = float((2 * r + 1) ** 3)
    rk3 = torch.tensor(np.float32(1.0) / np.float32(k3))
    by_reciprocal = (a.float() * rk3).to(torch.bfloat16)
    torch.testing.assert_close(by_reciprocal, kmind._true_div(a, k3), rtol=0, atol=0)
    assert (a.float().abs() < 2.0**-126 * k3).sum() > 0  # subnormal quotients are in the set


# (14, 8, 16, 37): the semantic entry's 14 channels, d across the CUDA
# kernel's 32-voxel l tile and not a multiple of 4 (h and w stay multiples
# of 8, as the Pallas kernel requires)
@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("shape", [(4, 8, 8, 8), (3, 16, 24, 10), (14, 8, 16, 37)])
def test_cost_volume_matches_pallas(rng, q, shape):
    fix = rng.standard_normal(shape).astype(np.float32)
    mov = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(cost_volume_pallas(jnp.asarray(fix), jnp.asarray(mov), q, interpret=True))
    out = cost_volume(torch.from_numpy(fix), torch.from_numpy(mov), q).numpy()
    # channel sums in another order than the Pallas jnp.sum: rtol 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def _cost_volume_source() -> str:
    return (pathlib.Path(__file__).resolve().parent.parent / "convexadam_torch" / "csrc"
            / "cost_volume.cu").read_text()


def test_cost_volume_kernel_choice_covers_the_sweep():
    """The wrapper's choice by q: every half-width of the self-configuring
    sweep, 1..7, runs the kernel compiled for it; every other q, task 1's 8
    among them, runs the general kernel (q at run time); and the C entry
    compiles exactly those q, each for itself."""
    assert list(COMPILED_Q) == [1, 2, 3, 4, 5, 6, 7]
    assert [kernel_for(q) for q in range(1, 8)] == ["cost_volume_kernel"] * 7
    assert {kernel_for(q) for q in (0, 8, 9, 15, 16, 24)} == {"cost_volume_general_kernel"}
    src = _cost_volume_source()
    # the C entry chooses the metric, then dispatch<SAD> the instantiation
    entry = src[src.index("int dispatch("):]
    cases = re.findall(r"case (\d+): return launch<(\d+), SAD>", entry)
    assert [(int(a), int(b)) for a, b in cases] == [(q, q) for q in COMPILED_Q]
    assert "dispatch<true>" in entry and "dispatch<false>" in entry
    assert "if (general) return launch_general<SAD>" in entry


@pytest.mark.parametrize("q", list(COMPILED_Q))
def test_cost_volume_dispatch_compiles_each_q(q):
    """``dispatch`` has one case for each compiled q, launching that q's
    instantiation, and the wrapper sends q there."""
    entry = _cost_volume_source()
    entry = entry[entry.index("int dispatch("):]
    assert len(re.findall(rf"case {q}: return launch<{q}, SAD>\(", entry)) == 1
    assert kernel_for(q) == "cost_volume_kernel"


@pytest.mark.parametrize("q", [0, 8, 9, 12, 16, 17, 24])
def test_general_kernel_blocks_tile_every_k(q):
    """The general kernel's loops, replayed from the constants of its
    source: the kd blocks start on 16-byte boundaries and tile K = 2q + 1
    exactly, each with a size its ``switch`` has a case for (no masked
    operation); the warps take every kw, at most ``GMAX_WARPS`` of them."""
    src = _cost_volume_source()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (KB|GMAX_WARPS) = (\d+);", src)}
    body = src[src.index("switch (g.K - kd0 < KB"):]
    body = body[:body.index("}")]
    sizes = {const["KB"] if c == "KB" else int(c)
             for c in re.findall(r"case (KB|\d+): GENERAL_BLOCK\(", body)}
    assert sizes
    K = 2 * q + 1
    blocks = [(kd0, min(const["KB"], K - kd0)) for kd0 in range(0, K, const["KB"])]
    assert all(kd0 % 4 == 0 and nb in sizes for kd0, nb in blocks)
    assert sum(nb for _, nb in blocks) == K
    rounds = -(-K // const["GMAX_WARPS"])
    nw = -(-K // rounds)
    assert nw <= const["GMAX_WARPS"] and nw * rounds >= K
    assert kernel_for(q) == "cost_volume_general_kernel"


def _pallas_block(vol, pos):
    """The JAX package's gathered corner block (8C, N) of ``vol`` (C, H, W, D)
    at absolute voxel positions ``pos`` (3, N): corner stack + take."""
    C, H, W, D = vol.shape
    x0 = np.floor(pos).astype(np.int32)
    xb = np.clip(x0[0] + 1, 0, H)
    yb = np.clip(x0[1] + 1, 0, W)
    zb = np.clip(x0[2] + 1, 0, D)
    lin = (xb * (W + 1) + yb) * (D + 1) + zb
    stack = build_corner_stack(jnp.asarray(vol)).reshape(8 * C, -1)
    return jnp.take(stack, jnp.asarray(lin), axis=1)


def test_sample_trilinear_matches_corner_reduce_fwd(rng):
    C, H, W, D, n = 3, 6, 7, 8, 512
    vol = rng.standard_normal((C, H, W, D)).astype(np.float32)
    # normalized coordinates reaching past the volume on every side
    grid = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    pos = np.stack([((grid[:, a] + np.float32(1)) * np.float32(s) - np.float32(1))
                    * np.float32(0.5) for a, s in enumerate((H, W, D))])
    p0 = np.floor(pos)
    fracs = tuple(jnp.asarray(f) for f in (pos - p0))
    bases = tuple(jnp.asarray(b) for b in p0.astype(np.int32))
    ref = np.asarray(corner_reduce_fwd(
        _pallas_block(vol, pos), fracs, bases, (C, H, W, D), interpret=True
    ))
    out = sample_trilinear(torch.from_numpy(vol)[None], torch.from_numpy(grid)[None])[0]
    # weights and corner order as the Pallas kernel: atol 1e-6
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_sample_trilinear_bf16_matches_corner_reduce_fwd(rng):
    """A bfloat16 volume is read as stored: the Pallas kernel on the
    bfloat16 block, and the plain version equals its own float32 run on the
    same values to the bit."""
    C, H, W, D, n = 3, 6, 7, 8, 512
    vol = torch.from_numpy(rng.standard_normal((C, H, W, D)).astype(np.float32)).to(torch.bfloat16)
    grid = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    pos = np.stack([((grid[:, a] + np.float32(1)) * np.float32(s) - np.float32(1))
                    * np.float32(0.5) for a, s in enumerate((H, W, D))])
    p0 = np.floor(pos)
    ref = np.asarray(corner_reduce_fwd(
        _pallas_block(vol.float().numpy(), pos).astype(jnp.bfloat16),
        tuple(jnp.asarray(f) for f in (pos - p0)),
        tuple(jnp.asarray(b) for b in p0.astype(np.int32)), (C, H, W, D), interpret=True,
    ))
    g = torch.from_numpy(grid)[None]
    out = sample_trilinear(vol[None], g)[0]
    assert out.dtype == torch.float32
    assert torch.equal(out, sample_trilinear_plain(vol.float()[None], g)[0])
    # weights and corner order as the Pallas kernel: atol 1e-6
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_trilinear_batched_matches_corner_reduce_fwd(rng, dtype):
    """Two volumes of 14 channels (the semantic Adam grid's), points past
    every face: each batch element against the Pallas kernel on its own
    gathered block, in the volume's dtype."""
    B, C, H, W, D, n = 2, 14, 6, 7, 8, 512
    vol = torch.from_numpy(rng.standard_normal((B, C, H, W, D)).astype(np.float32))
    vol = vol.to(getattr(torch, dtype))
    grid = rng.uniform(-1.3, 1.3, (B, n, 3)).astype(np.float32)
    assert (grid < -1).any(axis=(0, 1)).all() and (grid > 1).any(axis=(0, 1)).all()
    out = sample_trilinear(vol, torch.from_numpy(grid))
    assert out.shape == (B, C, n) and out.dtype == torch.float32
    for b in range(B):
        pos = np.stack([((grid[b, :, a] + np.float32(1)) * np.float32(s) - np.float32(1))
                        * np.float32(0.5) for a, s in enumerate((H, W, D))])
        p0 = np.floor(pos)
        block = _pallas_block(vol[b].float().numpy(), pos).astype(getattr(jnp, dtype))
        ref = np.asarray(corner_reduce_fwd(
            block, tuple(jnp.asarray(f) for f in (pos - p0)),
            tuple(jnp.asarray(i) for i in p0.astype(np.int32)), (C, H, W, D), interpret=True,
        ))
        # weights and corner order as the Pallas kernel: atol 1e-6
        np.testing.assert_allclose(out[b].numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 12, 14])
def test_warp_ssd_loss_grad_matches_pallas(rng, dtype, C):
    H, W, D = 8, 8, 8
    n = H * W * D
    cost_scale = 12.0
    mov = rng.standard_normal((C, H, W, D)).astype(np.float32)
    if dtype == "bfloat16":
        mov = torch.from_numpy(mov).to(torch.bfloat16).float().numpy()
    fix = rng.standard_normal((C, n)).astype(np.float32)
    disp = (rng.standard_normal((3, H, W, D)) * 1.5).astype(np.float32)
    fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
    idx = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in (H, W, D)],
                               indexing="ij")).reshape(3, n)
    pos = idx + disp.reshape(3, n) * np.asarray(fac, np.float32)[:, None]
    chain = 2.0 * cost_scale / (C * n)
    block = _pallas_block(mov, pos)
    if dtype == "bfloat16":
        block = block.astype(jnp.bfloat16)
    ssq_p, dg_p = corner_reduce_loss_grad(
        block, jnp.asarray(pos), jnp.asarray(fix), jnp.float32(chain), (C, H, W, D),
        interpret=True,
    )
    mov_t = torch.from_numpy(mov).to(getattr(torch, dtype))
    ssq_t, rows_t = warp_ssd_loss_grad(
        mov_t, torch.from_numpy(disp), torch.from_numpy(fix), fac, chain
    )
    # the Pallas kernel's order (residuals, then per corner the channel sum,
    # then the rows); only its jnp.sum over the channels and over the tile
    # associate differently: about 2e-7 of the largest entry, hence 5e-7
    # (the order of value and three derivatives per channel needed 1e-5
    # relative plus 1e-5 of the largest entry)
    np.testing.assert_allclose(float(ssq_t), float(np.sum(ssq_p)), rtol=1e-6)
    dg_p = np.asarray(dg_p)
    np.testing.assert_allclose(rows_t.numpy(), dg_p, rtol=0, atol=5e-7 * np.abs(dg_p).max())


def _ic_loop(disp1, disp2, iters):
    """The inverse-consistency loop as ``core/warp.py`` ran it before the
    fused steps: per step the two grids, one batched sampler call of the
    swapped fields and the two updates."""
    shape = tuple(disp1.shape[1:])
    n = disp1[0].numel()
    identity = identity_grid_normalized(shape, False, device=disp1.device, dtype=disp1.dtype)
    d1, d2 = disp1, disp2
    for _ in range(iters):
        g1 = (identity + d1.permute(1, 2, 3, 0)).reshape(n, 3)
        g2 = (identity + d2.permute(1, 2, 3, 0)).reshape(n, 3)
        vol = torch.stack([d2, d1]).contiguous()
        out = sample_trilinear(vol, torch.stack([g1, g2]))
        s1 = out[0].reshape((3,) + shape)
        s2 = out[1].reshape((3,) + shape)
        d1, d2 = 0.5 * (d1 - s1), 0.5 * (d2 - s2)
    return d1, d2


@pytest.mark.parametrize("shape,amp,iters", [((7, 8, 6), 0.1, 15), ((9, 5, 11), 0.4, 4),
                                             ((6, 6, 6), 0.2, 0)])
def test_inverse_consistency_steps_plain_equals_old_loop(rng, shape, amp, iters):
    """The fused steps' plain version is the old loop moved: equal to the
    bit, also with points past every face (amplitude 0.4)."""
    fields = (rng.standard_normal((2, 3) + shape) * amp).astype(np.float32)
    f = torch.from_numpy(fields)
    out = inverse_consistency_steps_plain(f, iters)
    r1, r2 = _ic_loop(f[0], f[1], iters)
    assert out.shape == (2, 3) + shape
    assert torch.equal(out[0], r1) and torch.equal(out[1], r2)
    assert torch.equal(inverse_consistency_steps(f, iters), out)
    assert torch.equal(f, torch.from_numpy(fields))  # the input is left as it is


def test_cpu_wrappers_launch_nothing(rng):
    """CPU tensors take the plain versions: no launch is counted."""
    before = dict(LAUNCHES)
    x = torch.from_numpy(rng.standard_normal((8, 8, 8)).astype(np.float32))
    mind_ssd_stats(x, 1, 1)
    f = torch.from_numpy(rng.standard_normal((2, 4, 4, 4)).astype(np.float32))
    cost_volume(f, f, 1)
    sample_trilinear(f[None], torch.zeros((1, 5, 3)))
    sample_trilinear_bwd(f[None], torch.zeros((1, 5, 3)), torch.ones((1, 2, 5)), 2.0)
    warp_ssd_loss_grad(f, torch.zeros((3, 4, 4, 4)), f.reshape(2, -1), (1.0, 1.0, 1.0), 1.0)
    inverse_consistency_steps(torch.zeros((2, 3, 4, 4, 4)), 3)
    assert LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["mind", "cost_volume", "sample", "sample_ic", "sample_bwd",
                                     "warp_ssd"])
def test_wrappers_refuse_other_devices(wrapper):
    """A tensor that is neither on the CPU nor on CUDA raises: the plain
    version is taken only for CPU tensors."""
    m = torch.empty((2, 4, 4, 4), device="meta")
    calls = {
        "mind": lambda: mind_ssd_stats(m[0], 1, 1),
        "cost_volume": lambda: cost_volume(m, m, 1),
        "sample": lambda: sample_trilinear(m[None], torch.empty((1, 5, 3), device="meta")),
        "sample_ic": lambda: inverse_consistency_steps(
            torch.empty((2, 3, 4, 4, 4), device="meta"), 15),
        "sample_bwd": lambda: sample_trilinear_bwd(
            m[None], torch.empty((1, 5, 3), device="meta"), torch.empty((1, 2, 5), device="meta"),
            1.0,
        ),
        "warp_ssd": lambda: warp_ssd_loss_grad(m, m[:3], m.reshape(2, -1), (1.0,) * 3, 1.0),
    }
    with pytest.raises(ValueError, match="CPU or CUDA"):
        calls[wrapper]()
