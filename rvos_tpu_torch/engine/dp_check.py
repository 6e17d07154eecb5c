"""Data-parallel training held to one process (the checks of
``tests/test_torch_port_parallel_train.py`` and ``chip_smoke.py`` phase
7a).

``data_parallel_steps`` is a rank of a run started by
``parallel.launch``: a ``Trainer`` from given weights takes this rank's
contiguous slice of each global batch as a step and returns what a check
compares — per step the metrics, the gradients as the optimizer reads
them (after the reduce, before the update) and the parameters after it.

``per_item_steps`` is its reference in one process: each item of the
global batch alone (its loss, backward and gradients, with the global
batch's k-means draws and dropout masks for that item), the gradients
summed over the items in order and divided by their number, the
optimizer stepped on that mean.  A two-rank run reduces the same two
gradients by one addition and the same division, so on one thread the
two are equal bit for bit: loss, gradients and parameters.

``fit_steps`` is a rank of a run that trains through ``Trainer.fit``
over ``SyntheticTrain`` (logs, checkpoints, resume).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import Config
from ..ops import prng
from ..parallel import distributed
from .train import Trainer, batch_to_device

TIME_MAJOR = ("curr_img", "curr_label")


def batch_slice(batch: Dict[str, np.ndarray], start: int, size: int
                ) -> Dict[str, np.ndarray]:
    """Items ``[start, start + size)`` of a global batch."""
    return {k: (v[:, start:start + size] if k in TIME_MAJOR
                else v[start:start + size]) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def data_parallel_steps(rank: int, world: int, device: torch.device,
                        cfg: Config,
                        init_state: Optional[Dict[str, torch.Tensor]],
                        batches: Sequence[Dict[str, np.ndarray]],
                        seed: int = 0, keep: Optional[int] = None) -> Dict:
    """One rank (``parallel.launch`` target): ``Trainer.train_step`` on
    this rank's slice of each global batch of ``batches``, the run's
    step keys in order (``init_state`` None: the weights ``seed`` makes).
    Returns ``{"steps": [metrics + "step_ms" and, for the first ``keep``
    steps (default all), "grads" (after the reduce), "local_grads"
    (before it) and "params" (after the update)], "peak_gb",
    "launches"}`` — ``launches``: the kernel wrappers' counts in this
    process."""
    from .. import ops

    tr = Trainer(cfg, device=device, init_state=init_state, seed=seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    keep = len(batches) if keep is None else keep
    out = []
    for i, batch in enumerate(batches):
        keep_grads = i < keep
        start, size = distributed.process_batch_slice(
            batch["curr_img"].shape[1])
        tr.run_key, key = prng.next_step_key(tr.run_key)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}

        def record(stage, model):
            if keep_grads:
                grads[stage] = {n: p.grad.detach().clone()
                                for n, p in model.named_parameters()}

        _sync(device)
        t0 = time.perf_counter()
        m = tr.train_step(batch_slice(batch, start, size), key, record)
        _sync(device)
        step_ms = (time.perf_counter() - t0) * 1e3
        m = {k: v for k, v in m.items() if k != "pred"}
        out.append(dict(m, grads=grads.get("reduced"),
                        local_grads=grads.get("backward"), step_ms=step_ms,
                        params=_params(tr.model) if keep_grads else None))
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    launches = {k: getattr(ops, k).launches for k in (
        "global_seg_map", "global_seg", "global_flat_min", "local_match")}
    return {"steps": out, "peak_gb": peak, "launches": launches}


def per_item_steps(cfg: Config,
                   init_state: Optional[Dict[str, torch.Tensor]],
                   batches: Sequence[Dict[str, np.ndarray]], seed: int = 0,
                   device="cpu") -> Dict:
    """The single-process reference of ``data_parallel_steps``: per
    global batch, each item alone through ``loss_fn`` (with its share of
    the global batch's draws), the gradients and losses averaged over the
    items (summed in item order, divided by their number), one optimizer
    step on the mean.  Returns ``{"steps": [{"loss", "seq_losses",
    "grads", "grad_norm"}], "params"}``."""
    tr = Trainer(cfg, device=device, init_state=init_state, seed=seed)
    out = []
    for batch in batches:
        n = batch["curr_img"].shape[1]
        tr.run_key, key = prng.next_step_key(tr.run_key)
        seeds = tr.draw_seeds()
        sums: Dict[str, torch.Tensor] = {}
        loss_sum = losses_sum = None
        for b in range(n):
            tr.optimizer.zero_grad()
            loss, (losses, _, _) = tr._step_fn.loss_fn(
                batch_to_device(batch_slice(batch, b, 1), tr.device),
                tr.step, key.to(tr.device), seeds, (b, n))
            loss.backward()
            for name, p in tr.model.named_parameters():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                sums[name] = g.clone() if name not in sums else sums[name] + g
            loss_sum = (loss.detach() if loss_sum is None
                        else loss_sum + loss.detach())
            losses_sum = (losses.detach() if losses_sum is None
                          else losses_sum + losses.detach())
        for name, p in tr.model.named_parameters():
            p.grad = sums[name].div_(n)
        grads = {k: v.clone() for k, v in sums.items()}
        res = tr.optimizer.step()
        tr.step += 1
        out.append({"loss": loss_sum / n, "seq_losses": losses_sum / n,
                    "grads": grads, "grad_norm": res["grad_norm"]})
    return {"steps": out, "params": _params(tr.model)}


def fit_steps(rank: int, world: int, device: torch.device, cfg: Config,
              steps: int, seed: int = 0, save_every: int = 0,
              length: int = 8) -> Dict:
    """One rank of ``Trainer.fit`` to ``steps`` over ``SyntheticTrain``
    (``length`` clips) through ``TrainBatcher``'s slices, checkpoints in
    the result dir (auto-resume per ``cfg``).  Returns the trainer's
    step, data position, update count and parameters."""
    from ..cli.train import train_transform
    from ..data import SyntheticTrain, TrainBatcher

    data = SyntheticTrain(size=cfg.DATA_RANDOMCROP,
                          curr_len=cfg.DATA_CURR_SEQ_LEN, length=length)
    batcher = TrainBatcher(data, cfg.TRAIN_BATCH_SIZE,
                           train_transform(cfg, True), num_workers=1,
                           process_index=rank, process_count=world)
    tr = Trainer(cfg, device=device, seed=seed)
    start = tr.step
    tr.fit(batcher, log_every=1, max_steps=steps, save_every=save_every,
           ckpt_dir=cfg.result_dirs()["ckpt"])
    return {"start": start, "step": tr.step, "data_pos": tr.data_pos,
            "count": tr.optimizer.count, "params": _params(tr.model)}
