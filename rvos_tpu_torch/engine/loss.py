"""Hard-mining losses and the training IoU (PyTorch port of
``rvos_tpu/engine/loss.py``).

Per-pixel cross-entropy (255 = ignore) averaged over the top-k% hardest
pixels, k annealed from 100 % to ``top_k_percent`` over
``hard_mining_step`` steps.  The k-th largest loss is picked on detached
losses and every pixel at or above it is kept (``>= kth``), as the JAX
package does; ignored pixels sit at −1, below any real loss, so they are
never picked.  k is computed in float32, as JAX computes it: in float64
the floor can land on another integer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mined_count(n: int, step: int, top_k_percent: float,
                hard_mining_step: int) -> int:
    """``floor((ratio·p + 1 − ratio)·n)``, at least 1, with ``ratio =
    min(1, step / hard_mining_step)``, in float32 arithmetic."""
    f32 = np.float32
    if hard_mining_step == 0:
        k = f32(int(top_k_percent * n))
    else:
        ratio = np.minimum(f32(1.0), f32(step) / f32(hard_mining_step))
        k = np.floor((ratio * f32(top_k_percent) + (f32(1.0) - ratio))
                     * f32(n))
    return int(max(k, f32(1.0)))


def _mined_mean(flat: torch.Tensor, valid, step: int, top_k_percent: float,
                hard_mining_step: int) -> torch.Tensor:
    k = mined_count(flat.numel(), step, top_k_percent, hard_mining_step)
    flat_sg = flat.detach()
    if valid is not None:
        flat_sg = torch.where(valid, flat_sg, torch.full_like(flat_sg, -1.0))
    kth = torch.topk(flat_sg, k).values[-1]
    sel = flat_sg >= kth
    if valid is not None:
        sel = sel & valid
    sel = sel.to(flat.dtype)
    return (flat * sel).sum() / sel.sum().clamp(min=1.0)


def hard_mining_ce(logits: torch.Tensor, labels: torch.Tensor, step: int,
                   top_k_percent: float = 0.15,
                   hard_mining_step: int = 50_000) -> torch.Tensor:
    """``logits`` [O, H, W] (invalid objects at −1e9); ``labels`` [H, W]
    int (255 = ignore) → the mined mean cross-entropy."""
    o = logits.shape[0]
    logp = torch.log_softmax(logits, dim=0)
    ignore = labels == 255
    lab = torch.where(ignore, torch.zeros_like(labels), labels).long()
    onehot = F.one_hot(lab, o).permute(2, 0, 1).to(logp.dtype)
    pix = -(logp * onehot).sum(0)
    pix = torch.where(ignore, torch.zeros_like(pix), pix)
    return _mined_mean(pix.reshape(-1), (~ignore).reshape(-1), step,
                       top_k_percent, hard_mining_step)


def hard_mining_bce(logits: torch.Tensor, onehot_target: torch.Tensor,
                    step: int, top_k_percent: float = 0.15,
                    hard_mining_step: int = 50_000) -> torch.Tensor:
    """Per-object BCE, averaged over objects per pixel, then the mined
    mean over pixels.  ``logits``, ``onehot_target``: [O, H, W]."""
    pix = (logits.clamp(min=0) - logits * onehot_target
           + torch.log1p(torch.exp(-logits.abs())))
    return _mined_mean(pix.mean(0).reshape(-1), None, step, top_k_percent,
                       hard_mining_step)


def batched_iou(pred: torch.Tensor, target: torch.Tensor,
                obj_num: torch.Tensor, max_obj: int,
                epsilon: float = 1e-6) -> torch.Tensor:
    """Mean foreground IoU for the train log: ``pred``, ``target``
    [B, H, W] int; ``obj_num`` [B]; objects 1 … max_obj−1, those above an
    item's ``obj_num`` left out; an item without objects counts 1."""
    ids = torch.arange(1, max_obj, device=pred.device)
    pm = pred[:, None] == ids[None, :, None, None]
    tm = target[:, None] == ids[None, :, None, None]
    inter = (pm & tm).sum((2, 3)).float()
    union = (pm | tm).sum((2, 3)).float()
    iou = (inter + epsilon) / (union + epsilon)
    valid = ids[None] <= obj_num[:, None]
    iou = torch.where(valid, iou, torch.zeros_like(iou))
    per = iou.sum(1) / valid.sum(1).clamp(min=1)
    return torch.where(obj_num > 0, per, torch.ones_like(per)).mean()
