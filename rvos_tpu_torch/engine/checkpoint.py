"""Training checkpoints and pretrained warm starts (the torch side of
``rvos_tpu/engine/checkpoint.py``; orbax stays with the JAX package).

A checkpoint is ``<ckpt_dir>/save_step_<N>.pth``: ``torch.save`` of the
trainer's state — the model's state dict, the optimizer's (its momentum
buffers and update count), the step, and where the run's draws and data
stand — written to a temporary name and renamed; the newest
``max_keep`` are kept.  ``load_pretrained`` warm-starts a model from a
reference ``.pth`` (all of it, or as a backbone-only file under
``feature_extracter``) or from a checkpoint of this trainer, merging the
keys whose names and shapes fit and reporting the others.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..weights import read_reference_checkpoint


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"save_step_{step}.pth")


def list_checkpoint_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"save_step_(\d+)\.pth", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def save_checkpoint(ckpt_dir: str, step: int, state: Dict,
                    max_keep: int = 8) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, step)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in list_checkpoint_steps(ckpt_dir)[:-max_keep]:
        os.remove(_ckpt_path(ckpt_dir, old))
    return path


def restore_checkpoint_path(path: str) -> Dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None
                       ) -> Tuple[Dict, int]:
    """The given step's checkpoint, or the newest → (state, step)."""
    steps = list_checkpoint_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    return restore_checkpoint_path(_ckpt_path(ckpt_dir, step)), step


def partial_restore(model: nn.Module, loaded: Dict[str, torch.Tensor]
                    ) -> List[str]:
    """Copy into ``model`` every loaded tensor whose key and shape fit
    its state dict; returns the keys left out."""
    target = model.state_dict()
    removed = []
    with torch.no_grad():
        for k, v in loaded.items():
            if k in target and tuple(target[k].shape) == tuple(v.shape):
                target[k].copy_(v)
            else:
                removed.append(k)
    return removed


def load_pretrained(model: nn.Module, path: str, full: bool = True
                    ) -> Tuple[List[str], int]:
    """Warm-start ``model`` from ``path`` → (removed keys, loaded keys).

    A checkpoint of this trainer restores its model in full.  A
    reference ``.pth`` (``weights.read_reference_checkpoint``) restores
    the whole model when ``full``, else it is a backbone file whose keys
    are taken under ``feature_extracter``."""
    obj = restore_checkpoint_path(path)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        loaded = obj["model"]
    else:
        loaded = read_reference_checkpoint(path)
        if not full:
            loaded = {k if k.startswith("feature_extracter.")
                      else f"feature_extracter.{k}": v
                      for k, v in loaded.items()}
    return partial_restore(model, loaded), len(loaded)
