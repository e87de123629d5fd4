"""PyTorch + CUDA port of ConvexAdam for one NVIDIA H100.

The main path is the default MIND registration (:func:`convex_adam`, and
:func:`convex_adam_torch` on tensors); the nnU-Net
semantic registration of two label volumes is
:func:`convex_adam_semantic_torch` (and of two raw images, through the
U-Net front end of :mod:`convexadam_torch.models`,
:func:`convex_adam_semantic_from_images`), the self-configuring grid's nine-variant
run :func:`convex_adam_multi_output`, the Learn2Reg evaluation of a
registered case :func:`evaluate_field`, the self-configuring sweep over
convex and Adam settings and the Learn2Reg task driver
:mod:`convexadam_torch.selfconfig`.  Files are read and written by
:mod:`convexadam_torch.geometry` (NIfTI-1, MetaImage); the reference's
signatures are :mod:`convexadam_torch.compat`, the Learn2Reg challenge
recipes (tasks 1-3 and CuRIOUS) :mod:`convexadam_torch.pipeline.challenges`,
and the command lines
:mod:`convexadam_torch.cli` (``register``, ``apply``, ``translation``,
``sweep``, ``l2r``).  Their hot kernels are hand-written CUDA for
``sm_90a`` under ``csrc/``, wrapped in ``kernels/``; each wrapper runs its
plain PyTorch version only for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def _resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means the card: ``cuda``, raising when no GPU is visible.

    An explicit ``"cpu"`` is the only way to run on the CPU (the tests do
    so); nothing falls back to it quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "convexadam_torch runs on CUDA by default and no GPU is "
                "visible; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


from convexadam_torch.pipeline.apply import apply_convex, apply_convex_torch  # noqa: E402
from convexadam_torch.pipeline.convex_adam import (  # noqa: E402
    ConvexAdamConfig,
    convex_adam,
    convex_adam_multi_output,
    convex_adam_semantic_from_images,
    convex_adam_semantic_torch,
    convex_adam_torch,
)
from convexadam_torch.selfconfig.l2r import evaluate_field  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ConvexAdamConfig", "apply_convex", "apply_convex_torch", "convex_adam",
    "convex_adam_multi_output", "convex_adam_semantic_from_images",
    "convex_adam_semantic_torch", "convex_adam_torch",
    "evaluate_field", "__version__",
]
