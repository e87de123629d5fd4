"""CLI: apply a displacement field to a moving image (apply_convex.py:81-97).

Counterpart of ``convexadam_tpu/cli/apply.py``, flag for flag, plus
``--device``."""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Warp a moving image by a field")
    parser.add_argument("--input_field", required=True,
                        help="displacement field (.nii.gz), full resolution")
    parser.add_argument("--input_moving", required=True, help="moving scan")
    parser.add_argument("--output_warped", required=True, help="output path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ('cuda' or 'cpu')")
    args = parser.parse_args(argv)

    from convexadam_torch.geometry.io import load_volume_nib_order, save_volume_nib_order
    from convexadam_torch.pipeline.apply import apply_convex

    moving, moving_affine = load_volume_nib_order(args.input_moving)
    disp, _ = load_volume_nib_order(args.input_field)

    warped = apply_convex(np.asarray(disp, np.float32), np.asarray(moving, np.float32),
                          device=args.device)
    save_volume_nib_order(warped.astype(np.float32), moving_affine, args.output_warped)
    print(f"wrote {args.output_warped}")


if __name__ == "__main__":
    main()
