"""How often a bf16 training step's local-matching cube ties at its
minimum, and how far JAX's split of a tied gradient moves the gradient
from giving it all to the first winner.

    python -m rvos_tpu_torch.cli.local_ties [--calls 4]

One ``loss_fn`` with its backward of the ``resnet101_aocnet`` preset
under ``TRAIN_COMPUTE_DTYPE="bfloat16"`` at ``chip_smoke.py`` phase 6a's
setting (465×465 synthetic clips, T = 5, O = 6, batch 2, random weights
from a seed), keeping the inputs of the first ``--calls`` calls of
``LocalMatchingMin`` and the gradient that reaches each output.  Per
call: the share of (pixel, frame, object, radius) minima below the 5e4
sentinel that are tied (two or more window entries equal to the
minimum), and the gradients of ``x`` and ``ys`` two ways from the same
bf16 cube and output gradient: JAX's split (the port's backward) and
first winner (the lowest window offset takes it all), with the relative
L2 of their difference.  Prints one JSON line per call.  Runs on the
card unless ``--device cpu`` (e.g. at ``--size 65``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile


def first_winner(cube, labels, radii, atrous_rate):
    """Per output of ``LocalMatchingMin`` on ``cube`` [S, K, h, w, K]:
    the lowest window offset ``dy·K + dx`` at the minimum, the number of
    entries equal to it, and the minimum, each [S, h, w, O, n_r]."""
    import torch
    import torch.nn.functional as F

    from ..ops.cuda_local import _window
    from ..ops.train_matching import _PEN

    order, a_max, pad_d = _window(radii, atrous_rate)
    a = atrous_rate
    s_n, k, h, w, _ = cube.shape
    labp = F.pad(labels.float(), (0, 0) + (pad_d,) * 4)
    lab = torch.stack([labp[dy * a:dy * a + h].unfold(1, w, a)
                       .permute(0, 3, 1, 2) > 0.9 for dy in range(k)])
    idx, ties, mins = [], [], []
    for r in order:
        lo, hi = a_max - r, a_max + r + 1
        dm = torch.where(lab[lo:hi, :, :, lo:hi][None],
                         cube[:, lo:hi, :, :, lo:hi, None].float(), _PEN)
        dm = dm.permute(0, 2, 3, 5, 1, 4).flatten(-2)   # [S,h,w,O,win²]
        mn, am = dm.min(-1)
        side = hi - lo
        idx.append((am // side + lo) * k + am % side + lo)
        ties.append((dm == mn[..., None]).sum(-1))
        mins.append(mn)
    return (torch.stack(idx, -1), torch.stack(ties, -1),
            torch.stack(mins, -1))


def tie_report(x, ys, labels, radii, a, g) -> dict:
    """One call's tie share and the two backwards' gap."""
    import torch

    from ..ops.cuda_local import _window
    from ..ops.train_matching import (_PEN, _bf16_cube, local_min_backward,
                                      local_matching_min)

    _, a_max, pad_d = _window(radii, a)
    cube = _bf16_cube(x, ys.to(x.dtype), pad_d, a, 2 * a_max + 1)
    idx, n_eq, mins = first_winner(cube, labels, radii, a)
    real = mins < _PEN
    xl, yl = x.detach().requires_grad_(), ys.detach().requires_grad_()
    local_matching_min(xl, yl, labels, radii, a).backward(g)
    dx_f, dy_f = local_min_backward(x.float(), ys.float(), labels, idx,
                                    g.float(), radii, a)

    def rel(got, want):
        return float((got - want).norm() / want.norm())

    gx, gy = xl.grad.float(), yl.grad.float()
    both = torch.cat([gx.flatten(), gy.flatten()])
    return {"outputs": int(real.sum()),
            "tied_share": float((n_eq[real] > 1).float().mean()),
            "mean_tied_entries": float(n_eq[real & (n_eq > 1)].float()
                                       .mean()) if bool((real & (n_eq > 1))
                                                        .any()) else 0.0,
            "dx_rel_l2": rel(dx_f, gx), "dys_rel_l2": rel(dy_f, gy),
            "all_rel_l2": rel(torch.cat([dx_f.flatten(), dy_f.flatten()]),
                              both),
            "shape": list(cube.shape), "radii": list(radii)}


def capture(trainer, batch, key, n_calls: int):
    """One ``loss_fn`` and backward of ``trainer`` with the inputs of the
    first ``n_calls`` ``LocalMatchingMin`` calls and their outputs'
    gradients."""
    from ..engine.train import batch_to_device
    from ..ops import train_matching

    calls = []
    real = train_matching.LocalMatchingMin.apply

    def spy(x, ys, labels, radii, a):
        out = real(x, ys, labels, radii, a)
        if len(calls) < n_calls:
            rec = {"args": (x.detach(), ys.detach(), labels.detach(),
                            radii, a)}
            out.register_hook(lambda g, rec=rec: rec.update(g=g.detach()))
            calls.append(rec)
        return out

    train_matching.LocalMatchingMin.apply = spy
    try:
        loss, _ = trainer._step_fn.loss_fn(
            batch_to_device(batch, trainer.device), trainer.step,
            key.to(trainer.device))
        loss.backward()
    finally:
        train_matching.LocalMatchingMin.apply = real
    return calls


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, default=465)
    args = p.parse_args(argv)

    import torch

    from ..data import SyntheticTrain, TrainBatcher
    from ..engine.train import Trainer
    from ..ops import prng
    from .profile_train import train_config
    from .train import train_transform

    card = "cpu"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("local_ties measures the card: no CUDA device")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as root:
        cfg = train_config(2, 1, root, TRAIN_COMPUTE_DTYPE="bfloat16",
                           DATA_MAX_OBJ_NUM=5).replace(
            TRAIN_REMAT=False, DATA_RANDOMCROP=(args.size, args.size))
        trainer = Trainer(cfg, device=args.device, seed=args.seed)
        data = SyntheticTrain(size=cfg.DATA_RANDOMCROP,
                              curr_len=cfg.DATA_CURR_SEQ_LEN,
                              obj_num=cfg.DATA_MAX_OBJ_NUM, length=2)
        batch = next(iter(TrainBatcher(data, 2, train_transform(cfg, True),
                                       num_workers=1).epoch(0)))
        key = prng.next_step_key(prng.prng_key(prng.TRAIN_SEED))[1]
        calls = capture(trainer, batch, key, args.calls)
        for i, rec in enumerate(calls):
            r = tie_report(*rec["args"], rec["g"])
            print(json.dumps({"call": i, **r, "card": card}), flush=True)


if __name__ == "__main__":
    main()
