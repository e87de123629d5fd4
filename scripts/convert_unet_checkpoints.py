"""Convert the JAX package's U-Net checkpoints for the PyTorch port.

Reads each orbax checkpoint under ``convexadam_tpu/models/checkpoints/<name>/``
through ``convexadam_tpu.models.segmentation.load_unet3d``, carries it across
with ``convexadam_torch.convert.unet_state_dict_from_flax`` and writes
``convexadam_torch/models/checkpoints/<name>/params.npz`` (the ``state_dict``
as float32 arrays) with a copy of ``meta.json`` beside it.  Run once, from the
repository root, where JAX and orbax are installed:

    JAX_PLATFORMS=cpu python scripts/convert_unet_checkpoints.py

The port itself reads only the ``.npz`` files and imports no JAX.
"""

from __future__ import annotations

import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("unet3d_anatomies", "unet3d_prostate_adc", "unet3d_prostate_multi")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from convexadam_torch.convert import unet_state_dict_from_flax
    from convexadam_torch.models.segmentation import CHECKPOINTS, save_unet3d
    from convexadam_tpu.models.segmentation import load_unet3d

    for name in NAMES:
        src = ROOT / "convexadam_tpu" / "models" / "checkpoints" / name
        dst = CHECKPOINTS / name
        dst.mkdir(parents=True, exist_ok=True)
        state = unet_state_dict_from_flax(load_unet3d(src / "params"))
        save_unet3d(state, dst / "params.npz")
        shutil.copyfile(src / "meta.json", dst / "meta.json")
        print(f"{name}: {len(state)} tensors -> {dst / 'params.npz'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
