"""Hand-written Hopper kernels of the main path and their plain versions.

Each wrapper runs its kernel's plain PyTorch version for tensors on the
CPU, and for CUDA tensors launches the kernel (built from ``csrc/`` at first
use) or raises.  :data:`LAUNCHES` counts the kernel launches of each
wrapper; a wrapper adds one for each launch, where it launches and nowhere
else, so a run can show that the main path went through its kernels.
"""

from __future__ import annotations

KERNEL_NAMES = (
    "mind_ssd_stats", "cost_volume", "sample_trilinear", "sample_trilinear_ic",
    "sample_trilinear_bwd", "warp_ssd_loss_grad", "nearest_sq", "nearest_sq_dual",
    "nearest_sq_pruned", "coupled_argmin", "box_mean3",
    # variants of three of the kernels above, counted on their own: the SAD
    # metric, candidate blocks of the streamed convex path, the general
    # cost-volume kernel (SSD at a q without its own instantiation), the
    # data term on a strided sub-lattice, and the general MIND kernel (an
    # (r, d) without its own instantiation)
    "cost_volume_sad", "cost_volume_block", "cost_volume_general",
    "warp_ssd_loss_grad_strided", "mind_ssd_stats_general",
)

LAUNCHES: dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
