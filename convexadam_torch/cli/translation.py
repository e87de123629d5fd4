"""CLI: translation-only registration (convex_adam_translation.py:148-166).

Counterpart of ``convexadam_tpu/cli/translation.py``, flag for flag, plus
``--device``."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Apply convex Adam translation to an image."
    )
    parser.add_argument("--fixed_path", type=Path, required=True)
    parser.add_argument("--moving_path", type=Path, required=True)
    parser.add_argument("--segmentation_path", type=Path, default=None)
    parser.add_argument("--moving_output_path", type=Path, required=True)
    parser.add_argument("--co_moving_paths", type=Path, nargs="+", default=None)
    parser.add_argument("--co_moving_output_paths", type=Path, nargs="+", default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    # validate before the registration runs: co-moving inputs need matching
    # outputs, or they would fail or be dropped at the end
    n_co = len(args.co_moving_paths or [])
    n_co_out = len(args.co_moving_output_paths or [])
    if n_co != n_co_out:
        parser.error(
            f"--co_moving_paths gave {n_co} inputs but "
            f"--co_moving_output_paths gave {n_co_out} outputs"
        )

    from convexadam_torch.geometry.io import read_image, write_image
    from convexadam_torch.pipeline.translation import convex_adam_translation

    fixed = read_image(args.fixed_path)
    moving = read_image(args.moving_path)
    seg = read_image(args.segmentation_path) if args.segmentation_path else None
    co = [read_image(p) for p in args.co_moving_paths] if args.co_moving_paths else None

    translation_xyz, moved, co_moved = convex_adam_translation(
        fixed, moving, segmentation=seg, co_moving_images=co, device=args.device
    )
    write_image(moved, args.moving_output_path)
    if co_moved is not None:
        for img, p in zip(co_moved, args.co_moving_output_paths):
            write_image(img, p)
    print(f"translation_xyz_mm: {tuple(float(t) for t in translation_xyz)}")
    print(f"wrote {args.moving_output_path}")


if __name__ == "__main__":
    main()
