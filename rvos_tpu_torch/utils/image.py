"""Palette PNG masks and the train log's overlays (the port's own copy
of ``rvos_tpu/utils/image.py``'s ``save_mask``, ``label2colormap`` and
``masked_image``): the DAVIS/YouTube-VOS palette, with a gray ramp tail
that makes the label-125 "uncertain" marker visible.  PIL is imported
only when a mask is written."""

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


def label2colormap(label: np.ndarray) -> np.ndarray:
    """Bit-twiddled colormap of a label map [H, W] → [H, W, 3] uint8
    (for the train image log)."""
    m = label.astype(np.uint8)
    r, c = m.shape
    cmap = np.zeros((r, c, 3), dtype=np.uint8)
    cmap[:, :, 0] = (m & 1) << 7 | (m & 8) << 3 | (m & 64) >> 1
    cmap[:, :, 1] = (m & 2) << 6 | (m & 16) << 2 | (m & 128) >> 2
    cmap[:, :, 2] = (m & 4) << 5 | (m & 32) << 1
    return cmap


def masked_image(image: np.ndarray, colored_mask: np.ndarray,
                 mask: np.ndarray, alpha: float = 0.7) -> np.ndarray:
    """Blend a colored mask into a CHW image where ``mask`` > 0."""
    m = np.repeat((mask > 0)[None], 3, axis=0)
    return (image * alpha + colored_mask * (1 - alpha)) * m + image * (1 - m)
