"""Sweep-state checkpoint and resume.

Counterpart of ``convexadam_tpu/selfconfig/checkpoint.py``.  The reference
checkpoints its sweep metrics with ``torch.save`` after every setting
(convex_run_withconfig.py:156, adam_run_withconfig_shiftSpline.py:265-266)
but never resumes.  Here the state (the metric arrays and the indices of the
completed settings) is written after every setting, and the sweeps skip
completed settings on resume.

The file is the JAX package's fallback schema, ``<base>.ckpt.npz`` with the
arrays ``dice``, ``jstd``, ``hd95``, ``times`` and ``completed``, so either
package resumes from the other's file.  It is written to a temporary file in
the same directory and moved into place with ``os.replace``: a crash leaves
the previous checkpoint or the new one, never a torn file.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np


class SweepCheckpointer:
    """Atomic checkpointing of sweep metric state keyed by a base path.

    ``save(state)`` / ``restore() -> state | None`` where ``state`` is a
    flat dict of numpy arrays (must contain ``completed``: the sorted
    indices of fully-evaluated settings).
    """

    def __init__(self, path):
        self.base = Path(str(path))

    @property
    def path(self) -> Path:
        # distinct from a final results npz saved to the base path itself,
        # which would otherwise replace the checkpoint with a schema that
        # lacks "completed"
        return self.base.with_suffix(self.base.suffix + ".ckpt.npz")

    def save(self, state: dict) -> None:
        target = self.path
        fd, tmp = tempfile.mkstemp(dir=target.parent, prefix=target.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{k: np.asarray(v) for k, v in state.items()})
            os.replace(tmp, target)
        except BaseException:
            os.unlink(tmp)
            raise

    def restore(self) -> Optional[dict]:
        if not self.path.exists():
            return None
        with np.load(self.path) as f:
            return {k: f[k] for k in f.files}

    def clear(self) -> None:
        self.path.unlink(missing_ok=True)
