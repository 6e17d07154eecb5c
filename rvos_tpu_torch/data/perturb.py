"""Robust-VOS-Benchmark perturbations as frame transforms (the port's
own copy of ``rvos_tpu/data/perturb.py``).

  0 clean | 1/2/3 Gaussian noise σ ∈ {5, 10, 30} | 4/5/6 box blur
  k ∈ {3, 5, 9} | 7/8/9 salt and pepper at {1000, 1000, 5000} points.

Random draws come from an explicit ``np.random.Generator``, so the same
seed gives the JAX package's frames.  The box blur is numpy only (cv2
is not a dependency of the port): a separable k×k mean with ``cv2.blur``'s
default border (reflect-101), summed one shifted slice at a time, which
gives ``cv2.blur``'s values on integer-valued frames.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def gaussian_noise(img: np.ndarray, std: float,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Float noise added and clipped to [0, 255] (cv2.randn + cv2.add)."""
    rng = rng or np.random.default_rng()
    noise = rng.normal(0.0, std, img.shape).astype(np.float32)
    out = img.astype(np.float32) + noise
    return np.clip(out, 0, 255).astype(np.float32)


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Normalised k×k box filter over the first two axes, borders
    reflected without repeating the edge (``cv2.BORDER_REFLECT_101``)."""
    x = img.astype(np.float32)
    h, w = x.shape[:2]
    pad = k // 2
    widths = [(pad, k - 1 - pad), (pad, k - 1 - pad)] + [(0, 0)] * (x.ndim - 2)
    xp = np.pad(x, widths, mode="reflect")
    rows = sum(xp[i:i + h] for i in range(k))
    return sum(rows[:, j:j + w] for j in range(k)) / np.float32(k * k)


def salt_and_pepper(img: np.ndarray, n_points: int,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Alternating white and black pixels at ``n_points`` random points."""
    rng = rng or np.random.default_rng()
    out = img.astype(np.float32).copy()
    h, w = out.shape[:2]
    rows = rng.integers(0, h, n_points)
    cols = rng.integers(0, w, n_points)
    odd = np.arange(n_points) % 2 == 1
    out[rows[odd], cols[odd]] = 255.0
    out[rows[~odd], cols[~odd]] = 0.0
    return out


def get_perturbation(image_type: int,
                     rng: Optional[np.random.Generator] = None
                     ) -> Callable[[np.ndarray], np.ndarray]:
    """image_type 0-9 → frame transform."""
    table = {
        0: lambda x: x.astype(np.float32),
        1: lambda x: gaussian_noise(x, 5, rng),
        2: lambda x: gaussian_noise(x, 10, rng),
        3: lambda x: gaussian_noise(x, 30, rng),
        4: lambda x: box_blur(x, 3),
        5: lambda x: box_blur(x, 5),
        6: lambda x: box_blur(x, 9),
        7: lambda x: salt_and_pepper(x, 1000, rng),
        8: lambda x: salt_and_pepper(x, 1000, rng),
        9: lambda x: salt_and_pepper(x, 5000, rng),
    }
    if image_type not in table:
        raise ValueError(f"image_type must be 0-9, got {image_type}")
    return table[image_type]
