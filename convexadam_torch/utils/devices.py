"""Deadline-bounded device probe.

Counterpart of ``convexadam_tpu/utils/devices.py``: the number of CUDA
devices, asked in a subprocess with a deadline, so that a wedged CUDA runtime
cannot hang the caller and the calling process never initialises CUDA.
"""

from __future__ import annotations

import subprocess
import sys


def probe_device_count(timeout_s: float = 90.0) -> int:
    """``torch.cuda.device_count()`` as a fresh interpreter sees it, within
    ``timeout_s`` seconds; 0 on a timeout or any failure (treat as "no usable
    device")."""
    try:
        r = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
            capture_output=True, timeout=timeout_s, text=True,
        )
        if r.returncode != 0:
            return 0
        return int(r.stdout.strip().splitlines()[-1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return 0
