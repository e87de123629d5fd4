"""Guards of the port package ``convexadam_torch``: it stands alone beside
the JAX package, runs on the card unless asked for the CPU, and counts
kernel launches only where it launches."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from convexadam_torch.convert import config_from_fields, tensor_from_numpy
from convexadam_torch.kernels import KERNEL_NAMES, LAUNCHES, _build, reset_launches
from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

torch.set_num_threads(2)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_PORT_FILES = sorted((_ROOT / "convexadam_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]
_MODULES = sorted(
    ".".join(p.relative_to(_ROOT).with_suffix("").parts).replace(".__init__", "")
    for p in (_ROOT / "convexadam_torch").rglob("*.py")
)


_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "convexadam_tpu")


def test_import_pulls_in_no_jax():
    """Importing every module of the port leaves ``jax``, ``flax``,
    ``optax``, ``orbax`` and ``convexadam_tpu`` out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"for m in {_MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_BANNED!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_top_level_exports_the_main_entries():
    """The package's top level exports the counterparts of the JAX
    package's (``convexadam_tpu/__init__.py``), and importing them pulls in
    no ``jax``."""
    code = (
        "import sys\n"
        "from convexadam_torch import (ConvexAdamConfig, __version__, apply_convex,\n"
        "    apply_convex_torch, convex_adam, convex_adam_torch)\n"
        "import convexadam_torch as c\n"
        "from convexadam_torch.pipeline import convex_adam as pipe, apply as ap\n"
        "assert convex_adam is pipe.convex_adam and ConvexAdamConfig is pipe.ConvexAdamConfig\n"
        "assert convex_adam_torch is pipe.convex_adam_torch and apply_convex is ap.apply_convex\n"
        "assert apply_convex_torch is ap.apply_convex_torch and __version__ == '0.1.0'\n"
        "assert set(c.__all__) >= {'ConvexAdamConfig', 'convex_adam', 'apply_convex',\n"
        "    'convex_adam_torch', 'apply_convex_torch', 'evaluate_field', '__version__',\n"
        "    'convex_adam_semantic_from_images'}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'convexadam_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _PORT_FILES, ids=lambda p: str(p.relative_to(_ROOT)))
def test_sources_import_no_jax(path):
    """No file of the port, nor chip_smoke.py, imports JAX, flax, optax,
    orbax or the JAX package."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in _BANNED, (path, name)


def test_entry_point_defaults_to_cuda(monkeypatch):
    """Without ``device`` the entry point runs on CUDA, and raises where
    there is none; it never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((12, 12, 12), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convex_adam(z, z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convex_adam(z, z, device="cuda")
    with pytest.raises(RuntimeError):
        tensor_from_numpy(z)


def test_cpu_path_launches_no_kernel():
    """A whole CPU registration takes the plain versions: every launch
    count stays 0."""
    reset_launches()
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((16, 16, 16)).astype(np.float32)
    out = convex_adam(vol, np.roll(vol, 1, 0), device="cpu", grid_sp=4, disp_hw=1,
                      selected_niter=2)
    assert out.shape == (16, 16, 16, 3) and np.isfinite(out).all()
    assert set(LAUNCHES) == set(KERNEL_NAMES)
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_config_round_trip_from_jax_fields():
    from convexadam_tpu.pipeline.convex_adam import ConvexAdamConfig as JaxConfig

    jcfg = JaxConfig(grid_sp=4, snapshot_iters=(40, 80), adam_smoother=("bank", 3))
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert config_from_fields(dataclasses.asdict(ConvexAdamConfig())) == ConvexAdamConfig()
    with pytest.raises(ValueError, match="unknown"):
        config_from_fields({"grid_sp": 4, "not_a_field": 1})


def test_tensor_from_numpy_keeps_layout_and_bf16():
    import ml_dtypes

    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.float32 and tuple(t.shape) == (2, 3, 4)
    np.testing.assert_array_equal(t.numpy(), a)
    b = tensor_from_numpy(a.astype(ml_dtypes.bfloat16), "cpu")
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.float().numpy(), a)


def test_dtype_auto_policy():
    cfg = ConvexAdamConfig()
    assert cfg.compute_dtype(torch.device("cpu")) == torch.float32
    assert cfg.compute_dtype(torch.device("cuda")) == torch.bfloat16
    assert ConvexAdamConfig(dtype="float32").compute_dtype(torch.device("cuda")) == torch.float32


def test_build_recipe():
    """The build targets sm_90a into build/kernels, one library per source,
    keyed by a hash of csrc/; a machine without nvcc raises."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == _ROOT / "build" / "kernels"
    for name in _build.KERNEL_SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build._lib_path(name).name.startswith(f"lib{name}_")
    if _build.shutil.which("nvcc") is None and not pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build._nvcc()


def test_resource_usage_reads_the_ptxas_report(tmp_path, monkeypatch):
    """Each build keeps ptxas's report beside its library; the registers
    and spills of every kernel are read from it by mangled name."""
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN1a14ic_step_kernelEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a14ic_step_kernelEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers, 392 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN1a11bwd_kernelIfEEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a11bwd_kernelIfEEv",
        "    40 bytes stack frame, 44 bytes spill stores, 40 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 40 bytes cumulative stack size",
    ])
    (tmp_path / "libwarp_x.log").write_text(log)
    monkeypatch.setattr(_build, "_lib_path", lambda name: tmp_path / f"lib{name}_x.so")
    assert _build.resource_usage("warp") == {
        "_ZN1a14ic_step_kernelEv": {"registers": 32, "spill_stores": 0, "spill_loads": 0},
        "_ZN1a11bwd_kernelIfEEv": {"registers": 64, "spill_stores": 44, "spill_loads": 40},
    }
