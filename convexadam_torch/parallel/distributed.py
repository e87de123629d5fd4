"""Process groups for multi-device sweeps, and the collectives the port uses.

Counterpart of ``convexadam_tpu/parallel/distributed.py``.  The reference's
only multi-accelerator story is one sweep process per GPU
(``CUDA_VISIBLE_DEVICES=argv[1]``, convex_run_withconfig.py:42-43); the JAX
package spans devices with one SPMD program.  Here every rank is a process
that runs the same script, joins one ``torch.distributed`` process group, and
computes its share of the work; the results come back to every rank through
host-side gathers, so every rank returns the same result.

Usage (the same script on every rank, e.g. under ``torchrun``):

    from convexadam_torch.parallel import distributed, batch
    distributed.init_distributed()          # reads the environment; no-op for one process
    mesh = batch.make_sweep_mesh()          # (setting, pair) grid over the ranks
    res = run_stage1_sweep(..., mesh=mesh)  # the same metrics on every rank

NCCL needs a card of its own for each rank; ranks that share a card, or CPU
tensors, use gloo (which takes CUDA tensors too, copying them through the
host itself).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group that ``torch.distributed``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them) or the arguments describe.

    ``backend``: ``"nccl"`` where each rank has a card of its own (the rank's
    card is ``LOCAL_RANK``, made current), ``"gloo"`` for CPU tensors or
    ranks sharing a card; by default NCCL when CUDA is available, else gloo.
    ``init_method`` defaults to ``"env://"``.  Returns True when this process
    is one of several ranks; a world of one process is a no-op returning
    False, and a group joined before is kept."""
    if dist.is_initialized():
        return is_multiprocess()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, **kwargs)
    return True


def world(group=None) -> "tuple[int, int]":
    """(size, rank) of ``group`` (the default group); (1, 0) when no
    process group is joined."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def is_multiprocess() -> bool:
    """Whether this process is one of several ranks of a process group."""
    return world()[0] > 1


def make_global(arr, sharding=None):
    """Returns ``arr`` unchanged.  The JAX package turns host arrays into
    global sharded arrays here; in the port every rank loads the whole
    dataset (as the reference's per-GPU processes do) and computes its own
    share of it, so there is no global array to make."""
    return arr


def all_gather_tensor(t: torch.Tensor, group=None) -> "list[torch.Tensor]":
    """``t`` of every rank of ``group`` (each of the same shape), in rank
    order, on ``t``'s device."""
    out = [torch.empty_like(t) for _ in range(world(group)[0])]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def all_gather_object(obj, group=None) -> list:
    """A picklable ``obj`` of every rank of ``group``, in rank order."""
    out = [None] * world(group)[0]
    dist.all_gather_object(out, obj, group=group)
    return out
