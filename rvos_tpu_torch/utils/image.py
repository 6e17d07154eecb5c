"""Palette PNG masks (the port's own copy of
``rvos_tpu/utils/image.py::save_mask``): the DAVIS/YouTube-VOS palette,
with a gray ramp tail that makes the label-125 "uncertain" marker
visible.  PIL is imported only when a mask is written."""

from __future__ import annotations

import os

import numpy as np

_BASE_COLORS = [
    0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128, 128, 0, 128,
    0, 128, 128, 128, 128, 128, 64, 0, 0, 191, 0, 0, 64, 128, 0, 191, 128, 0,
    64, 0, 128, 191, 0, 128, 64, 128, 128, 191, 128, 128, 0, 64, 0, 128, 64, 0,
    0, 191, 0, 128, 191, 0, 0, 64, 128, 128, 64, 128,
]
PALETTE = list(_BASE_COLORS) + [v for i in range(22, 256) for v in (i, i, i)]


def save_mask(mask: np.ndarray, path: str) -> None:
    """Save an int label map as a palette PNG."""
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    im = Image.fromarray(mask.astype(np.uint8), mode="P")
    im.putpalette(PALETTE)
    im.save(path, compress_level=1)
