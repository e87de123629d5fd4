"""Device memory reporting (the reference's ``gpu_usage``,
convex_adam_utils.py:138-139) and a profiler trace.

Counterpart of ``convexadam_tpu/utils/memory.py``, whose stage timers the
port's spans replace (``utils/trace.py``: on while this trace records).
"""

from __future__ import annotations

import contextlib

import torch


def device_usage(device: "str | torch.device | None" = None) -> str:
    """Memory the caching allocator holds for tensors on a CUDA ``device``
    (the current one by default), now and at its peak, as a human-readable
    string (``torch.cuda.memory_allocated`` / ``max_memory_allocated``)."""
    cur = torch.cuda.memory_allocated(device) * 1e-9
    peak = torch.cuda.max_memory_allocated(device) * 1e-9
    return f"device usage (current/peak): {cur:.2f} / {peak:.2f} GB"


@contextlib.contextmanager
def profile_trace(log_dir):
    """Record a ``torch.profiler`` trace of the CPU and (where a card is
    visible) CUDA activity of a block, written as a Chrome trace
    (``trace.json``) under ``log_dir``.  Use it around one registration or
    one sweep setting: traces of long sweeps get large."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
