"""Eval-side frame transforms (the port's own copy of the numpy parts of
``rvos_tpu/data/transforms.py``): ``restrict_size`` caps the long edge,
applies the multi-scale factor and snaps H, W to the (x−1)%16==0 grid
the stride tower expects; ``eval_variants`` builds the per-scale
variants.  cv2 or PIL is imported only when a frame is resized."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _resize_img(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bicubic frame resize (cv2 when installed, else PIL)."""
    if img.shape[:2] == tuple(hw):
        return img
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(img, dsize=(hw[1], hw[0]),
                          interpolation=cv2.INTER_CUBIC)
    from PIL import Image
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (hw[1], hw[0]), Image.BICUBIC)).astype(img.dtype)


def snap_16(x: int) -> int:
    """(x-1) % 16 == 0 snap."""
    if (x - 1) % 16 != 0:
        x = int(np.around((x - 1) / 16.0) * 16 + 1)
    return x


def restrict_size(h: int, w: int, max_size: Optional[float] = 800 * 1.3,
                  min_size: Optional[int] = None,
                  scale: float = 1.0) -> Tuple[int, int]:
    """Eval resize policy (reference MultiRestrictSize)."""
    sc = None
    if min_size is not None:
        short = min(h, w)
        if short > min_size:
            sc = float(min_size) / short
    else:
        long = max(h, w)
        if max_size is not None and long > max_size:
            sc = float(max_size) / long
    nh, nw = (h, w) if sc is None else (sc * h, sc * w)
    return snap_16(int(nh * scale)), snap_16(int(nw * scale))


def variant_list(flip: bool, multi_scale: Sequence[float]
                 ) -> List[Tuple[float, bool]]:
    """(scale, flip) of each eval variant, in ``eval_variants``' order."""
    return [(s, f) for s in multi_scale
            for f in ((False, True) if flip else (False,))]


def eval_variants(img: np.ndarray, max_size: Optional[float],
                  min_size: Optional[int], flip: bool,
                  multi_scale: Sequence[float]) -> List[Dict]:
    """One resized variant per scale (+ a flip twin per scale when
    ``flip``; flip twins carry the unflipped pixels)."""
    h, w = img.shape[:2]
    sized = {}
    variants = []
    for scale, f in variant_list(flip, multi_scale):
        if scale not in sized:
            nh, nw = restrict_size(h, w, max_size, min_size, scale)
            sized[scale] = (_resize_img(img, (nh, nw))
                            if (nh, nw) != (h, w) else img)
        variants.append({"img": sized[scale], "flip": f, "scale": scale})
    return variants


def frame_u8(img: np.ndarray) -> np.ndarray:
    """uint8 frame for upload: round-to-nearest of float frames."""
    if img.dtype == np.uint8:
        return img
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)
