"""Rank grids and batch registration over several ranks.

Counterpart of ``convexadam_tpu/parallel/batch.py``.  The JAX package lays
a ``jax.sharding.Mesh`` over its devices and lets GSPMD insert collectives;
here a :class:`Mesh` lays the ranks of a ``torch.distributed`` process
group (:func:`~convexadam_torch.parallel.distributed.init_distributed`)
over a two-axis grid, and each rank computes the share its coordinates
name:

* **pairs**: :func:`register_pairs_sharded` gives each rank a contiguous
  block of the case pairs along the ``pair`` axis and gathers the fields;
  the sweeps (``selfconfig``) spread pairs the same way;
* **settings**: the sweeps spread each batch of settings along the
  ``setting`` axis (:func:`make_sweep_mesh`);
* **space**: ``register_pairs_sharded(..., shard_space=True)`` splits each
  volume of a pair along H over the ``space`` axis; the ranks of a
  ``space`` group exchange the halos of every stencil explicitly
  (:mod:`convexadam_torch.parallel.spatial`), where the JAX package leaves
  them to GSPMD;
* **displacements**: ``core/convex.py:convex_displacement_tp`` spreads the
  (2q+1)^3 candidates of one convex stage over a process group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from convexadam_torch import _resolve_device
from convexadam_torch.parallel.distributed import all_gather_tensor, is_multiprocess, world
from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam_torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a two-axis grid of ranks (row-major: rank =
    coord0 * shape[1] + coord1), its device, and per axis the process
    group of the ranks that differ from it along that axis only (``None``
    in a world of one process)."""

    axis_names: tuple
    shape: tuple
    rank: int
    device: torch.device
    groups: dict

    @property
    def distributed(self) -> bool:
        """Whether the grid spans several processes (the gathers run
        through their process group)."""
        return is_multiprocess()

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the grid lacks)."""
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for an axis the grid
        lacks)."""
        if axis not in self.axis_names:
            return 0
        return divmod(self.rank, self.shape[1])[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)


def shard_range(n: int, n_shards: int, coord: int) -> range:
    """The contiguous block of ``range(n)`` that shard ``coord`` of
    ``n_shards`` holds: ``ceil(n / n_shards)`` items, fewer (or none) at the
    end."""
    chunk = -(-n // n_shards)
    return range(min(coord * chunk, n), min((coord + 1) * chunk, n))


def _grid(names: tuple, shape: tuple, device) -> Mesh:
    n, rank = world()
    if shape[0] * shape[1] != n:
        raise ValueError(f"a {names} grid of {shape} needs {shape[0] * shape[1]} ranks, "
                         f"the process group has {n}")
    dev = _resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    groups: dict = {}
    if n > 1:
        # every rank makes every subgroup, in one order (dist.new_group is
        # collective)
        for a, name in enumerate(names):
            other = 1 - a
            for o in range(shape[other]):
                ranks = [r for r in range(n) if divmod(r, shape[1])[other] == o]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = g
    return Mesh(tuple(names), tuple(shape), rank, dev, groups)


def make_mesh(n_pair: Optional[int] = None, n_space: int = 1, device=None) -> Mesh:
    """A (pair, space) grid over the ranks of the process group (one rank
    without one).  ``device``: this rank's device, ``cuda`` (the current
    card) unless ``"cpu"``."""
    if n_pair is None:
        n_pair = world()[0] // n_space
    return _grid(("pair", "space"), (n_pair, n_space), device)


def make_sweep_mesh(
    n_setting: Optional[int] = None, n_pair: Optional[int] = None, device=None
) -> Mesh:
    """A (setting, pair) grid for the sweeps' fan-out, the counterpart of
    the reference's process-per-GPU sweeps (convex_run_withconfig.py:42-43):
    settings spread along ``setting``, case pairs along ``pair``.  With
    neither given, two settings at a time on an even number of ranks above
    one, else one."""
    n = world()[0]
    if n_setting is None and n_pair is None:
        n_setting = 2 if (n % 2 == 0 and n > 1) else 1
    if n_pair is None:
        n_pair = n // n_setting
    if n_setting is None:
        n_setting = n // n_pair
    return _grid(("setting", "pair"), (n_setting, n_pair), device)


def _volumes(x, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, torch.float32)


def register_pairs_batched(
    fixed, moving, cfg: Optional[ConvexAdamConfig] = None, device=None
) -> torch.Tensor:
    """The MIND pipeline on each pair of a batch, one after another on one
    device: (B, H, W, D) x 2 → (B, H, W, D, 3); each field is a lone
    :func:`convex_adam_torch` call's.  Runs on ``cuda`` unless
    ``device="cpu"``."""
    dev = _resolve_device(device)
    cfg = cfg or ConvexAdamConfig()
    f, m = _volumes(fixed, dev), _volumes(moving, dev)
    return torch.stack([convex_adam_torch(f[i], m[i], cfg) for i in range(f.shape[0])])


def register_pairs_sharded(
    fixed, moving, cfg: ConvexAdamConfig, mesh: Mesh, shard_space: bool = False
) -> torch.Tensor:
    """Register a batch of pairs spread over ``mesh``'s ``pair`` axis: each
    rank registers its contiguous block (the batch padded with the last
    pair to a multiple of the axis), the blocks are gathered along the axis,
    and every rank returns the (B, H, W, D, 3) fields on its device, each
    equal to :func:`register_pairs_batched`'s.

    Without ``shard_space`` the ranks along ``space`` repeat the work.  With
    ``shard_space=True`` they split each pair along H
    (:func:`~convexadam_torch.parallel.spatial.register_slab`): a rank moves
    only its slab to its device, and the slab edges fall on multiples of
    :func:`~convexadam_torch.parallel.spatial.slab_unit` rows; where a
    volume holds fewer such units than ``space`` ranks, the last ranks hold
    no rows and receive the gathered fields.  Either way the fields are
    :func:`register_pairs_batched`'s to the bit.  A volume that the one-process
    run refuses (``check_grids``) raises ``ValueError``, naming its rows along
    H."""
    B, n = len(fixed), mesh.size("pair")
    chunk = -(-B // n)
    idx = [min(i, B - 1) for i in range(chunk * n)]
    mine = idx[mesh.coord("pair") * chunk:(mesh.coord("pair") + 1) * chunk]
    if shard_space:
        local = _register_space(fixed, moving, mine, cfg, mesh)
    else:
        f, m = _volumes(fixed, mesh.device), _volumes(moving, mesh.device)
        local = register_pairs_batched(f[mine], m[mine], cfg, device=mesh.device)
    if not mesh.distributed:
        return local[:B]
    return torch.cat(all_gather_tensor(local, mesh.group("pair")))[:B]


def _register_space(fixed, moving, pairs, cfg, mesh: Mesh) -> torch.Tensor:
    """The pairs ``pairs`` of the batch, each split along H over ``mesh``'s
    ``space`` axis: (len(pairs), H, W, D, 3) on every rank of the axis."""
    from convexadam_torch.parallel.spatial import register_slab, slab_plan, slab_unit

    H = int(torch.as_tensor(fixed[0]).shape[0])
    plan = slab_plan(H, slab_unit(cfg), mesh.size("space"), mesh.coord("space"))
    a, b = plan.own()
    fields = []
    for i in pairs:
        f, m = (torch.as_tensor(v[i])[a:b].to(mesh.device, torch.float32) for v in (fixed, moving))
        fields.append(register_slab(f, m, cfg, plan, mesh.group("space")))
    return torch.stack(fields)
