"""The port's sliding-window helpers (``convexadam_torch/utils/sliding_window.py``)
against the JAX package's, bit for bit, on seeded inputs."""

import numpy as np
import pytest

from convexadam_torch.utils import sliding_window as tsw
from convexadam_tpu.utils import sliding_window as jsw


@pytest.mark.parametrize("patch,image,step", [
    ((64, 64, 28), (96, 96, 56), 0.5), ((64, 64, 28), (192, 160, 256), 0.5),
    ((8, 8, 8), (20, 24, 28), 0.5), ((16, 16, 16), (16, 40, 17), 0.25),
    ((8, 8, 8), (8, 8, 8), 1.0),
])
def test_compute_steps_for_sliding_window(patch, image, step):
    assert tsw.compute_steps_for_sliding_window(patch, image, step) == \
        jsw.compute_steps_for_sliding_window(patch, image, step)


@pytest.mark.parametrize("patch,sigma", [((64, 64, 28), 1 / 8), ((8, 8, 8), 1 / 8),
                                         ((16, 9, 5), 0.3)])
def test_get_gaussian(patch, sigma):
    got, ref = tsw.get_gaussian(patch, sigma), jsw.get_gaussian(patch, sigma)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_nonzero_mask_bbox_and_crop(rng):
    """A hollow two-channel mask (holes filled), its box and the crop."""
    data = np.zeros((2, 20, 18, 16), np.float32)
    data[0, 4:12, 3:9, 5:14] = rng.random((8, 6, 9)) + 0.5
    data[1, 8:17, 6:15, 2:7] = 1.0
    data[1, 10:12, 8:10, 3:5] = 0.0  # a cavity
    for d in (data, data[:, :, :, 0]):
        np.testing.assert_array_equal(tsw.create_nonzero_mask(d), jsw.create_nonzero_mask(d))
    mask = tsw.create_nonzero_mask(data)
    box = tsw.get_bbox_from_mask(mask)
    assert box == jsw.get_bbox_from_mask(mask) == [[4, 17], [3, 15], [2, 14]]
    assert tsw.get_bbox_from_mask(mask.astype(int) + 1, outside_value=1) == box
    np.testing.assert_array_equal(tsw.crop_to_bbox(data[0], box), jsw.crop_to_bbox(data[0], box))
    with pytest.raises(ValueError):
        tsw.crop_to_bbox(data, box)
    with pytest.raises(ValueError):
        tsw.create_nonzero_mask(data[0, 0])
