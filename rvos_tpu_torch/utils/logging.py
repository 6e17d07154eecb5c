"""Training metrics log (the port's own copy of
``rvos_tpu/utils/logging.py``): one JSON line per logging step in
``<log_dir>/metrics.jsonl``, mirrored to TensorBoard when
``torch.utils.tensorboard`` imports, and ``TRAIN_IMG_LOG`` image dumps
(PIL imported when an image is written)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, tb: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        if tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_images(self, step: int, images: Dict[str, np.ndarray]):
        """Each entry an HWC image, written as
        ``<log_dir>/images/<step>_<name>.jpeg`` (uint8, clipped)."""
        from PIL import Image

        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        for name, arr in images.items():
            arr = np.asarray(arr)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(
                os.path.join(img_dir, f"{step:06d}_{name}.jpeg"))
            if self._tb is not None:
                self._tb.add_image(name, arr, int(step), dataformats="HWC")

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.flush()
