"""LR schedule, parameter groups and the optimizer (PyTorch port of
``rvos_tpu/engine/learning.py``).

The JAX package's optax chain, applied to the trainable group:
clip by the global norm of that group → coupled weight decay (GCT
``beta`` exempt unless ``MODEL_GCT_BETA_WD``) → nesterov SGD with the
schedule.  ``torch.optim.SGD(nesterov=True, dampening=0)`` applies the
update of ``optax.sgd(nesterov=True)``: its momentum buffer starts at the
first gradient, as optax's trace does from zeros.

``MODEL_FREEZE_BACKBONE`` leaves ``feature_extracter`` out of the
optimizer; its gradients are still computed, and count in the logged
global norm and in the non-finite check, as in the JAX package, but
not in the clip.  The frozen batch norms are buffers in the port.

The learning rate of an update is ``lr_schedule(count)``, ``count`` the
number of updates applied so far (optax's count): a skipped non-finite
step does not advance it, while the trainer's step counter does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from ..configs import Config


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Warm-up, then poly(``TRAIN_POWER``) or cosine decay, floored at
    1e-5, in float32 arithmetic as the JAX schedule."""
    f32 = np.float32
    base = f32(cfg.TRAIN_LR)
    warm = cfg.TRAIN_WARM_UP_STEPS
    mx = f32(cfg.TRAIN_TOTAL_STEPS - warm + 1)
    power = f32(cfg.TRAIN_POWER)
    cosine = cfg.TRAIN_COSINE_DECAY

    def fn(step) -> float:
        step = f32(step)
        if step < warm:
            lr = base * step / f32(max(1, warm))
        else:
            t = step - f32(warm)
            if cosine:
                lr = base * (np.cos(f32(math.pi) * t / mx) + f32(1.0)) \
                    * f32(0.5)
            else:
                with np.errstate(invalid="ignore"):    # NaN past the end
                    lr = base * (f32(1.0) - t / mx) ** power
        return float(np.maximum(f32(lr), f32(1e-5)))

    return fn


def param_groups(cfg: Config, model: nn.Module) -> Dict[str, List]:
    """``(name, parameter)`` pairs by group: ``decay`` and ``no_decay``
    (GCT ``beta`` when ``MODEL_GCT_BETA_WD`` is false) are trained,
    ``frozen`` (``feature_extracter`` under ``MODEL_FREEZE_BACKBONE``)
    is not."""
    groups = {"decay": [], "no_decay": [], "frozen": []}
    for name, p in model.named_parameters():
        if cfg.MODEL_FREEZE_BACKBONE and name.startswith("feature_extracter."):
            groups["frozen"].append((name, p))
        elif not cfg.MODEL_GCT_BETA_WD and name.rsplit(".", 1)[-1] == "beta":
            groups["no_decay"].append((name, p))
        else:
            groups["decay"].append((name, p))
    return groups


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖t‖² over the tensors, in float32 (optax ``global_norm``)."""
    sq = [t.float().square().sum() for t in tensors]
    return torch.stack(sq).sum().sqrt()


class TrainOptimizer:
    """Clip → coupled weight decay → nesterov SGD over the trainable
    parameters, with the update count that drives the schedule."""

    def __init__(self, cfg: Config, model: nn.Module):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        groups = param_groups(cfg, model)
        self.train_params = [p for k in ("decay", "no_decay")
                             for _, p in groups[k]]
        self.all_params = [p for _, p in model.named_parameters()]
        opt_groups = [{"params": [p for _, p in groups[k]],
                       "weight_decay": wd}
                      for k, wd in (("decay", cfg.TRAIN_WEIGHT_DECAY),
                                    ("no_decay", 0.0)) if groups[k]]
        self.sgd = torch.optim.SGD(opt_groups, lr=self.schedule(0),
                                   momentum=cfg.TRAIN_MOMENTUM,
                                   dampening=0.0, nesterov=True)
        self.count = 0

    def step(self) -> dict:
        """Apply one update from the parameters' ``.grad`` (a missing
        gradient counts as zero).  Returns ``grad_norm`` (over every
        parameter) and ``applied`` (false when the norm is not finite
        and ``TRAIN_SKIP_NONFINITE`` skipped the update).  Reading the
        two norms' flags on the host is the step's one sync."""
        for p in self.all_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm_all = global_norm([p.grad for p in self.all_params])
        clip = self.cfg.TRAIN_CLIP_GRAD_NORM
        norm = (norm_all if len(self.train_params) == len(self.all_params)
                else global_norm([p.grad for p in self.train_params]))
        ok, over = torch.stack([torch.isfinite(norm_all),
                                norm >= clip]).tolist()
        if self.cfg.TRAIN_SKIP_NONFINITE and not ok:
            return {"grad_norm": norm_all, "applied": False}
        if over:
            for p in self.train_params:
                p.grad.div_(norm).mul_(clip)
        lr = self.schedule(self.count)
        for g in self.sgd.param_groups:
            g["lr"] = lr
        self.sgd.step()
        self.count += 1
        return {"grad_norm": norm_all, "applied": True}

    def zero_grad(self):
        for p in self.all_params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"sgd": self.sgd.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])
