"""Gradient and update comparisons with a measured noise floor.

The training loss of a randomly initialised AOC-Net is a function whose
gradient moves by percents under rounding-sized changes: the random
ResNet-101 amplifies a relative change of 1e-7 to 1e-5 in the decoder's
activations, and at that size ReLU inputs, argmins and GroupNorm
statistics near their kinks flip, each flip moving a parameter's
gradient by a rank-one term.  Two correct implementations (the JAX
package and the port, the card and the CPU) round differently at every
layer and so part by that much.

So a gradient is held to ``rel_tol`` of each tensor's largest |g| or,
where the reference itself is less precise than that, to
``FLOOR_FACTOR`` times its *floor*: the largest change of that tensor's
gradient over three runs of the reference with every weight scaled by
``1 + WEIGHT_NOISE·N(0, 1)`` (about ten float32 ulps;
``perturbed_state``).  ``gradient_failures`` reports the tensors outside
both, and the comparison's summary says how many needed the floor and
the relative L2 error of all tensors together, which callers bound on
its own.  The noise was one ulp (1e-7) until a run on an H100 parted
the card from the CPU by 4.6 times that floor on one tensor of 370
(``chip_smoke.py`` phase 5b); it was raised to ten ulps after that
failure.

An optimizer has no such chaos once its gradients are given:
``update_check`` applies one update from the same state and the same
gradients on both sides and holds every parameter to ``UPDATE_TOL`` of
its scale, beside two controls that the same bar must catch.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

WEIGHT_NOISE = 1e-6
FLOOR_FACTOR = 3.0
UPDATE_TOL = 1e-6
# bars of the bf16 training routes' whole step against a reference step
# (the JAX package's on the CPU, the CPU's on a card): per-frame loss
# (relative), all gradients' relative L2, each tensor's ``rel_tol``.
# Measured in tests/test_torch_port_train_bf16.py, which says why the
# bf16-compute bars only bound the step's size (two bf16 computations
# part as far as bf16 and float32 do after a few layers); that route's
# power is in its stages alone (``engine.stage_check``).
BF16_BARS = {"compute": (0.35, 1.6, 2e-2), "matching": (8e-5, 6e-2, 2e-2)}


def perturbed_state(state: Dict[str, torch.Tensor], names, seed: int
                    ) -> Dict[str, torch.Tensor]:
    """``state`` with the tensors named in ``names`` (the parameters)
    scaled by ``1 + WEIGHT_NOISE·N(0, 1)``, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    out = dict(state)
    for n in names:
        v = state[n]
        noise = torch.randn(v.shape, generator=gen, dtype=torch.float32)
        out[n] = v * (1.0 + WEIGHT_NOISE * noise.to(v.device, v.dtype))
    return out


def floors(base: Dict[str, torch.Tensor],
           runs: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per tensor, the largest |Δg| of the perturbed runs from ``base``."""
    return {n: max(float((r[n].float() - g.float()).abs().max()) for r in runs)
            for n, g in base.items()}


def gradient_failures(got: Dict[str, torch.Tensor],
                      want: Dict[str, torch.Tensor],
                      floor: Dict[str, float], rel_tol: float
                      ) -> Tuple[List[str], Dict]:
    """Tensors where ``max|got − want| > max(rel_tol·max|want|,
    FLOOR_FACTOR·floor)``, and a summary: the worst error over scale,
    the relative L2 error of all tensors together, how many tensors were
    held by the floor."""
    bad, worst, by_floor, num, den = [], 0.0, 0, 0.0, 0.0
    for n, w in want.items():
        g, w = got[n].float().cpu(), w.float().cpu()
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        num += float((g - w).square().sum())
        den += float(w.square().sum())
        if scale == 0.0:
            if err > 0.0:
                bad.append(f"{n}: {err:.3e} where the reference is 0")
            continue
        worst = max(worst, err / scale)
        if err > rel_tol * scale:
            by_floor += 1
            if err > FLOOR_FACTOR * floor[n]:
                bad.append(f"{n}: {err:.3e} of {scale:.3e} (floor "
                           f"{floor[n]:.3e})")
    summary = {"tensors": len(want), "worst_rel": worst,
               "all_l2_rel": (num / den) ** 0.5 if den else 0.0,
               "held_by_floor": by_floor}
    return bad, summary


def update_check(card, ref, grads: Dict[str, torch.Tensor]) -> Dict:
    """One optimizer update of the trainer ``card`` and of the trainer
    ``ref`` from ``ref``'s state (weights, momentum, update count) and
    the same gradients ``grads`` (by parameter name; a missing one is
    zero).  Returns ``failures``, the tensors of the card's update past
    ``UPDATE_TOL`` of their largest |p|, and how many tensors the same
    bar finds in two controls, each of which must find some: the card
    applying no update (``no_update``) and applying it at 1.01 times
    the learning rate (``lr_1.01``)."""
    state = copy.deepcopy(ref.state_dict())

    def apply(tr, lr_scale=1.0):
        for n, p in tr.model.named_parameters():
            p.grad = grads[n].to(p.device).clone() if n in grads else None
        schedule = tr.optimizer.schedule
        tr.optimizer.schedule = lambda count: lr_scale * schedule(count)
        try:
            tr.optimizer.step()
        finally:
            tr.optimizer.schedule = schedule
        return {n: p.detach().cpu().clone()
                for n, p in tr.model.named_parameters()}

    before = {n: p.detach().cpu().clone()
              for n, p in ref.model.named_parameters()}
    want = apply(ref)
    # a copy for each load: on one device the optimizer keeps the
    # momentum buffers it is given and updates them in place
    card.load_state_dict(copy.deepcopy(state))
    wrong_lr = apply(card, 1.01)
    card.load_state_dict(state)
    got = apply(card)
    zero = dict.fromkeys(want, 0.0)
    bad, summary = gradient_failures(got, want, zero, UPDATE_TOL)
    return {"failures": bad, "worst_rel": summary["worst_rel"],
            "tensors": len(want),
            "no_update": len(gradient_failures(before, want, zero,
                                               UPDATE_TOL)[0]),
            "lr_1.01": len(gradient_failures(wrong_lr, want, zero,
                                             UPDATE_TOL)[0])}
