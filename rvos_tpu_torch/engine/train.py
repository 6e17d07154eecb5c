"""Training on one GPU or several (PyTorch port of
``rvos_tpu/engine/train.py``).

A step runs the JAX package's rollout of ``DATA_CURR_SEQ_LEN`` frames:

* uint8 frames are normalised on the device; the reference and previous
  frames go through the backbone once each, all T·B current frames in one
  batch;
* frame t is segmented against (ref, prev) item by item through
  ``AOCNet.segment_frame(..., train=True)`` — global and local matching
  through their differentiable Functions, never through a CUDA kernel —
  carrying the embedding (``TRAIN_SEQ_GRADIENT``: ``carry`` lets the
  gradient through the recurrence, ``detach`` stops it) and the decoder
  memory; after ``TRAIN_START_SEQ_TRAINING_STEPS`` the previous mask is
  the last prediction (burn-in) instead of the ground truth;
* logits are upsampled to the crop, the hard-mining CE is averaged over
  items and frames, and predictions are downscaled (nearest) for the
  next frame;
* ``TRAIN_REMAT``: ``torch.utils.checkpoint`` (non-reentrant) around
  each feature extraction and each frame's body.  The ASPP dropout of a
  call draws from a generator made from a seed drawn before the call,
  so a recomputation draws the same mask.
* ``TRAIN_COMPUTE_DTYPE="bfloat16"``: the forward runs on bf16 copies of
  every float32 parameter and buffer (the frozen batch norms' statistics
  too, which the JAX package holds as parameters) through
  ``torch.func.functional_call``; the casts are differentiated, so the
  gradients reach the float32 master parameters.  Frames go into the
  extractor in bf16, embeddings and the decoder memory stay bf16, and
  the logits go up to the crop in float32 for the loss.  Not
  ``torch.autocast``: its per-op policy would keep group norms and
  softmaxes in float32, where the JAX package's bf16 tower does not.
  With ``MATCHING_DTYPE="bfloat16"`` (``--float16``) the matching takes
  its bf16 operands (``ops.train_matching``).

Then the optimizer (``learning.TrainOptimizer``): the global norm of
every gradient, the non-finite skip (parameters and optimizer state
untouched; the step counter still advances), clip, decay, nesterov SGD.

k-means draws the JAX trainer's own scores (``ops.prng``): the run key
``PRNGKey(1234)`` is split once per step.  A fresh run sees the JAX
package's draws and data order; a resumed run continues both where the
checkpoint left them (the JAX trainer restarts them at resume).

Data parallelism (the JAX package's ``data`` mesh axis): one process per
card in a ``torch.distributed`` group (``parallel.launch``,
``cli/train.py --gpu_num N``), each with its contiguous slice of every
global batch (``TrainBatcher(process_index=, process_count=)``).  A
rank's items get exactly what a single process gives them: the k-means
draws and the dropout masks are drawn for the global batch and sliced
(``part``).  After ``backward`` the gradients are averaged over the
ranks in a few flat buffers (``parallel.distributed.reduce_mean_``) —
an explicit reduce, not ``DistributedDataParallel``: the step never
calls the model's ``forward`` and runs each method many times per
backward under non-reentrant checkpoints — and the optimizer clips,
skips and logs ``grad_norm`` from the reduced gradient on every rank
alike.  Parameters and optimizer state are broadcast from rank 0 after
construction and after a resume; losses and IoUs are global-batch means;
rank 0 alone writes logs, images and checkpoints, and every rank waits
for each save.  Context parallelism (``MESH_MODEL_AXIS > 1`` over the
process's ``devices``): ``GlobalMatchingMin``, cluster and proxy
matching split their query rows over the devices (``segment_frame``'s
``cp_devices``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..configs import Config
from ..device import configure_precision, resolve_device
from ..models import AOCNet, DecoderMemory
from ..models.deeplab import BatchDraws
from ..ops import prng
from ..parallel import distributed
from ..parallel.mesh import resolved_cp_devices
from ..ops.resize import resize_nchw
from ..weights import init_random_
from .learning import TrainOptimizer, lr_schedule
from .loss import batched_iou, hard_mining_ce


def check_train_config(cfg: Config) -> None:
    if cfg.TRAIN_COMPUTE_DTYPE not in ("float32", "bfloat16"):
        raise ValueError(
            f"TRAIN_COMPUTE_DTYPE {cfg.TRAIN_COMPUTE_DTYPE!r}")


def cast_state(module: nn.Module, dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """Every float32 parameter and buffer of ``module`` by name, cast to
    ``dtype`` (differentiably: a copy's gradient reaches its float32
    parameter); the others as they are.  ``functional_call(module,
    cast_state(module, torch.bfloat16), args)`` runs the bf16 forward of
    the training route."""
    return {n: t.to(dtype) if t.dtype == torch.float32 else t
            for n, t in [*module.named_parameters(),
                         *module.named_buffers()]}


class _Methods(nn.Module):
    """``forward(name, *args)`` calls the wrapped model's method ``name``
    (a dotted path reaches a submodule's): ``functional_call`` runs a
    module's ``forward`` only."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, method: str, *args, **kwargs):
        return _method(self.model, method)(*args, **kwargs)


def _method(model: nn.Module, path: str):
    obj = model
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def on_copies(model: nn.Module, dtype: torch.dtype):
    """``net(method, *args)``: ``model``'s method on copies of its float32
    parameters and buffers in ``dtype`` (``cast_state``); in float32, on
    the model itself."""
    if dtype == torch.float32:
        return lambda method, *args, **kw: _method(model, method)(*args,
                                                                  **kw)
    methods = _Methods(model)
    state = {f"model.{n}": t for n, t in cast_state(model, dtype).items()}
    return lambda *args, **kw: functional_call(methods, state, args, kw)


def _onehot(lab: torch.Tensor, o: int) -> torch.Tensor:
    """float one-hot on a new last axis; ids outside [0, o) give zeros,
    as ``jax.nn.one_hot``."""
    return (lab[..., None] == torch.arange(o, device=lab.device)).float()


def _downscale_labels(labels: torch.Tensor, hw) -> torch.Tensor:
    """[B, H, W] int → nearest at the embedding grid [B, h, w]."""
    return resize_nchw(labels, hw, "nearest")


def _normalize(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 frames → ImageNet-normalised float32 on their device; float
    frames are taken as already normalised."""
    if imgs.dtype != torch.uint8:
        return imgs.float()
    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
    mean = torch.as_tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.as_tensor(IMAGENET_STD, device=imgs.device)
    return (imgs.float() / 255.0 - mean) / std


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def bank_rows(cfg: Config, hw) -> int:
    """Rows of the training route's flat bank (one reference frame)."""
    g = cfg.TRAIN_GLOBAL_ATROUS_RATE
    rows = -(-hw[0] // g) * -(-hw[1] // g)
    cap = cfg.MATCHING_MAX_REF_PIXELS
    return min(rows, cap) if cap else rows


def make_train_step(cfg: Config, model: AOCNet, optimizer: TrainOptimizer,
                    cp_devices: Optional[Sequence[torch.device]] = None):
    """``train_step(batch, step, key, seeds, inspect)`` → metrics, with
    the loss as ``train_step.loss_fn(batch, step, key, seeds, part)`` →
    ``(loss, (losses [T], ious [T], last prediction or None))``.
    ``batch``: the ``TrainBatcher`` dict (this process's slice) on the
    model's device; ``key``: this step's key ([2] int64); ``seeds``: three
    dropout seeds (ref, prev, current frames) or None (no dropout);
    ``part``: ``(start, total)``, the slice's first item in a global batch
    of ``total`` (default: the batch is the whole batch).  ``train_step``
    takes the part of this process in its group and averages the
    gradients over the group before the optimizer; ``inspect(stage,
    model)``, when given, sees the gradients after the backward
    (``"backward"``) and after the reduce (``"reduced"``), before the
    update.
    ``cp_devices``: see ``segment_frame``."""
    o = min(cfg.DATA_MAX_OBJ_NUM + 1, cfg.MODEL_MAX_OBJ_NUM)
    remat = cfg.TRAIN_REMAT
    in_dtype = (torch.bfloat16 if cfg.TRAIN_COMPUTE_DTYPE == "bfloat16"
                else torch.float32)

    def extract(net, imgs, seed, groups, part):
        gen = None
        if seed is not None and cfg.MODEL_ASPP_DROPOUT > 0:
            gen = BatchDraws(
                torch.Generator(device=imgs.device).manual_seed(seed),
                groups, part[1], part[0])
        emb, low = net("extract_feature", _normalize(imgs).to(in_dtype), gen)
        return emb.to(in_dtype), low.to(in_dtype)

    def run_extract(net, imgs, seed, groups, part):
        if remat:
            return checkpoint(extract, net, imgs, seed, groups, part,
                              use_reentrant=False)
        return extract(net, imgs, seed, groups, part)

    def frame(net, step, cur_emb, cur_low, cur_lab_full, ref_emb, ref_onehot,
              prev_e, prev_l, obj_valid, slots, valid, scores):
        """One rollout frame for every item → (mean mined CE, full-res
        prediction, new memory slots and flags)."""
        one = torch.ones(1, device=cur_emb.device)
        logits, new_slots, new_valid = [], [], []
        for b in range(cur_emb.shape[0]):
            lg, mem = net(
                "segment_frame",
                cur_emb[b], cur_low[b], ref_emb[b][None], ref_onehot[b][None],
                one, prev_e[b], _onehot(prev_l[b], o), obj_valid[b],
                DecoderMemory(slots[b], valid[b]), scores[b], train=True,
                cp_devices=cp_devices)
            logits.append(lg)
            new_slots.append(mem.slots.to(in_dtype))
            new_valid.append(mem.valid)
        full = resize_nchw(torch.stack(logits).float(),
                           cur_lab_full.shape[-2:], "bilinear")
        losses = torch.stack([
            hard_mining_ce(full[b], cur_lab_full[b], step,
                           cfg.TRAIN_TOP_K_PERCENT_PIXELS,
                           cfg.TRAIN_HARD_MINING_STEP)
            for b in range(full.shape[0])])
        return (losses.mean(), full.argmax(1), torch.stack(new_slots),
                torch.stack(new_valid))

    def loss_fn(batch, step: int, key: torch.Tensor, seeds=None,
                part: Optional[Tuple[int, int]] = None):
        seeds = seeds if seeds is not None else (None, None, None)
        t_len, b = batch["curr_img"].shape[:2]
        part = (0, b) if part is None else part
        net = on_copies(model, in_dtype)
        ref_emb, _ = run_extract(net, batch["ref_img"], seeds[0], 1, part)
        prev_emb, _ = run_extract(net, batch["prev_img"], seeds[1], 1, part)
        _, h, w, _ = ref_emb.shape
        hw = (h, w)
        dev = ref_emb.device

        ref_lab = _downscale_labels(batch["ref_label"], hw)
        prev_lab = _downscale_labels(batch["prev_label"], hw)
        obj_valid = (torch.arange(o, device=dev)[None]
                     <= batch["obj_num"][:, None]).float()
        ref_onehot = _onehot(ref_lab, o)
        slots = torch.zeros((b, 2, o, cfg.MODEL_HEAD_EMBEDDING_DIM,
                             (h + 1) // 2, (w + 1) // 2), dtype=in_dtype,
                            device=dev)
        valid = torch.zeros((b, 2), dtype=torch.bool, device=dev)

        curr = batch["curr_img"]
        embs, lows = run_extract(net, curr.reshape((-1,) + curr.shape[2:]),
                                 seeds[2], t_len, part)
        embs = embs.reshape((t_len, b) + embs.shape[1:])
        lows = lows.reshape((t_len, b) + lows.shape[1:])
        # the global batch's draws, this slice's items (item i of the
        # batch draws from the i-th split of the step key)
        scores = prng.train_kmeans_scores(key, t_len, part[1], o,
                                          bank_rows(cfg, hw), dev
                                          )[:, part[0]:part[0] + b]

        prev_e, prev_gt, prev_pred = prev_emb, prev_lab, prev_lab
        use_pred = step > cfg.TRAIN_START_SEQ_TRAINING_STEPS
        losses, ious, pred_full = [], [], None
        for t in range(t_len):
            if cfg.TRAIN_SEQ_GRADIENT == "detach":
                prev_e = prev_e.detach()
            args = (net, step, embs[t], lows[t], batch["curr_label"][t],
                    ref_emb, ref_onehot, prev_e,
                    prev_pred if use_pred else prev_gt, obj_valid, slots,
                    valid, scores[t])
            if remat:
                loss_t, pred_full, slots, valid = checkpoint(
                    frame, *args, use_reentrant=False)
            else:
                loss_t, pred_full, slots, valid = frame(*args)
            losses.append(loss_t)
            ious.append(batched_iou(pred_full, batch["curr_label"][t],
                                    batch["obj_num"], o))
            prev_e = embs[t]
            prev_gt = _downscale_labels(batch["curr_label"][t], hw)
            prev_pred = _downscale_labels(pred_full, hw)
        losses = torch.stack(losses)
        last = pred_full if cfg.TRAIN_IMG_LOG else None
        return losses.mean(), (losses, torch.stack(ious), last)

    def train_step(batch, step: int, key: torch.Tensor, seeds=None,
                   inspect=None) -> Dict:
        b = batch["curr_img"].shape[1]
        start, _ = distributed.process_batch_slice(
            b * distributed.world_size())
        optimizer.zero_grad()
        loss, (losses, ious, last) = loss_fn(
            batch, step, key, seeds, (start, b * distributed.world_size()))
        loss.backward()
        out = {"reduce_bytes": 0, "reduce_ms": 0.0}
        for p in optimizer.all_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if inspect is not None:
            inspect("backward", model)
        if torch.distributed.is_initialized():
            _sync(loss.device)
            t0 = time.perf_counter()
            out["reduce_bytes"] = distributed.reduce_mean_(
                [p.grad for p in optimizer.all_params])
            _sync(loss.device)
            out["reduce_ms"] = (time.perf_counter() - t0) * 1e3
            # the global means: this slice's means averaged over the
            # slices (all of one size)
            t_len = losses.shape[0]
            seq = torch.cat([loss.detach()[None], losses.detach(),
                             ious]).float()
            distributed.reduce_mean_([seq])
            loss, losses, ious = seq[0], seq[1:t_len + 1], seq[t_len + 1:]
        if inspect is not None:
            inspect("reduced", model)
        res = optimizer.step()
        out.update({"loss": loss.detach(), "seq_losses": losses.detach(),
                    "iou": ious.mean(), "grad_norm": res["grad_norm"],
                    "applied": res["applied"], "pred": last})
        return out

    train_step.loss_fn = loss_fn
    return train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_log_images(batch: Dict[str, np.ndarray], pred_full: np.ndarray
                      ) -> Dict[str, np.ndarray]:
    """``TRAIN_IMG_LOG`` images of batch item 0: the reference and
    previous frames, the last frame's ground truth and prediction, each
    with its mask overlaid."""
    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ..utils.image import label2colormap, masked_image

    def denorm(img):
        if img.dtype == np.uint8:
            return img.astype(np.float32)
        x = img.astype(np.float32) * IMAGENET_STD + IMAGENET_MEAN
        return np.clip(x * 255.0, 0, 255)

    def overlay(img_hwc, lab):
        lab = np.asarray(lab).astype(np.uint8)
        cm = label2colormap(lab).transpose(2, 0, 1).astype(np.float32)
        out = masked_image(denorm(img_hwc).transpose(2, 0, 1), cm, lab)
        return out.transpose(1, 2, 0)

    curr_img = batch["curr_img"][-1][0]
    return {
        "ref_img": overlay(batch["ref_img"][0], batch["ref_label"][0]),
        "prev_img": overlay(batch["prev_img"][0], batch["prev_label"][0]),
        "groundtruth": overlay(curr_img, batch["curr_label"][-1][0]),
        "prediction": overlay(curr_img, pred_full),
    }


class Trainer:
    """Trainer of one process: model and optimizer, auto-resume, explicit
    resume or a pretrained warm start, and ``fit``; one rank of a
    data-parallel run when a ``torch.distributed`` group is initialized
    (``parallel.launch``, ``parallel.distributed.maybe_initialize``).

    ``device``: CUDA unless ``"cpu"`` is asked for (raises without a
    card).  ``init_state``: a state dict to start from (e.g. the JAX
    package's parameters through ``weights.from_jax_params``), else
    random weights from ``torch.Generator().manual_seed(seed)``; the
    same seed drives the dropout draws (every rank passes the same).
    ``devices``: this process's devices for context parallelism
    (``MESH_MODEL_AXIS``; default the trainer's device alone, on which
    the matching is not split)."""

    def __init__(self, cfg: Config, device=None,
                 init_state: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_train_config(cfg)
        configure_precision(cfg)
        model = AOCNet(cfg)
        if init_state is not None:
            model.load_state_dict(init_state, strict=True)
        else:
            init_random_(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.optimizer = TrainOptimizer(cfg, self.model)
        self.step = cfg.TRAIN_START_STEP
        self.lr_fn = lr_schedule(cfg)
        self.run_key = prng.prng_key(prng.TRAIN_SEED)
        self.data_pos = (0, 0)          # (epoch, batches done in it)
        self.dropout_gen = torch.Generator().manual_seed(seed)
        self.cp_devices = resolved_cp_devices(
            cfg, [self.device] if devices is None else devices)
        self._step_fn = make_train_step(cfg, self.model, self.optimizer,
                                        self.cp_devices)
        self._process_pretrained_model()
        self._broadcast_state()

    def _broadcast_state(self):
        """Rank 0's parameters, buffers and momentum to every rank (after
        construction and resume; a no-op outside a group)."""
        momentum = [self.optimizer.sgd.state[p]["momentum_buffer"]
                    for p in self.optimizer.train_params
                    if "momentum_buffer" in self.optimizer.sgd.state[p]]
        distributed.broadcast_([*self.model.parameters(),
                                *self.model.buffers(), *momentum])

    # -- state -----------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "run_key": self.run_key,
                "data_pos": list(self.data_pos),
                "dropout_gen": self.dropout_gen.get_state()}

    def load_state_dict(self, state: Dict):
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.run_key = state["run_key"].clone()
        self.data_pos = tuple(int(v) for v in state["data_pos"])
        self.dropout_gen.set_state(state["dropout_gen"])

    def _process_pretrained_model(self):
        """Auto-resume from the newest checkpoint of the result dir, else
        an explicit resume, else a pretrained warm start."""
        cfg = self.cfg
        if cfg.TRAIN_AUTO_RESUME and self._auto_resume():
            return
        if cfg.TRAIN_RESUME:
            self._explicit_resume()
            return
        if cfg.PRETRAIN and cfg.PRETRAIN_MODEL:
            from .checkpoint import load_pretrained
            removed, n_loaded = load_pretrained(
                self.model, cfg.PRETRAIN_MODEL, full=cfg.PRETRAIN_FULL)
            kind = "VOS model" if cfg.PRETRAIN_FULL else "backbone model"
            print(f"Load pretrained {kind} from {cfg.PRETRAIN_MODEL} "
                  f"({n_loaded - len(removed)}/{n_loaded} keys merged).")
            if removed:
                print(f"Remove {removed} from pretrained model.")

    def _auto_resume(self) -> bool:
        from .checkpoint import list_checkpoint_steps, restore_checkpoint
        ckpt_dir = self.cfg.result_dirs()["ckpt"]
        if not list_checkpoint_steps(ckpt_dir):
            return False
        state, step = restore_checkpoint(ckpt_dir)
        self.load_state_dict(state)
        print(f"Auto-resumed from step {step} ({ckpt_dir})")
        return True

    def _explicit_resume(self):
        """``TRAIN_RESUME_CKPT``: a step of the result dir or a checkpoint
        file (None: the newest); ``TRAIN_RESUME_STEP`` (non-zero)
        overrides the step the run continues from."""
        from .checkpoint import restore_checkpoint, restore_checkpoint_path
        cfg = self.cfg
        spec = cfg.TRAIN_RESUME_CKPT
        if spec is not None and os.path.isfile(str(spec)):
            self.load_state_dict(restore_checkpoint_path(str(spec)))
        else:
            want = int(spec) if spec is not None else None
            state, _ = restore_checkpoint(cfg.result_dirs()["ckpt"], want)
            self.load_state_dict(state)
        if cfg.TRAIN_RESUME_STEP:
            self.step = int(cfg.TRAIN_RESUME_STEP)
        if cfg.TRAIN_TOTAL_STEPS <= self.step:
            print("Your training has finished!")
        print(f"Resume from step {self.step}")

    def save(self, ckpt_dir: str) -> str:
        from .checkpoint import save_checkpoint
        return save_checkpoint(ckpt_dir, self.step, self.state_dict(),
                               self.cfg.TRAIN_MAX_KEEP_CKPT)

    # -- steps -----------------------------------------------------------
    def draw_seeds(self):
        """A step's three dropout seeds (reference, previous and current
        frames), from the trainer's generator."""
        return [int(s) for s in torch.randint(0, 2 ** 62, (3,),
                                              generator=self.dropout_gen)]

    def train_step(self, batch: Dict[str, np.ndarray], key: torch.Tensor,
                   inspect=None) -> Dict:
        """One step on this process's slice of a global batch."""
        seeds = self.draw_seeds()
        metrics = self._step_fn(batch_to_device(batch, self.device),
                                self.step, key.to(self.device), seeds,
                                inspect)
        self.step += 1
        return metrics

    def fit(self, batcher, log_every: int = 20, save_every: int = 0,
            ckpt_dir: str = "", max_steps: Optional[int] = None,
            callback=None):
        """Train to ``max_steps`` (default ``TRAIN_TOTAL_STEPS``), epoch
        after epoch of ``batcher``; print ``Itr:`` lines on the first
        step, every ``log_every`` and the last (and a JSON line each in
        the metrics log); checkpoint every ``save_every`` steps and at
        the end when ``ckpt_dir`` is given.  ``callback(step, metrics)``
        runs after each step (measurement scripts time steps with it).
        In a data-parallel run ``batcher`` yields this rank's slices; rank
        0 alone prints and writes, and every rank waits for each save."""
        from ..utils.logging import MetricsLogger
        cfg = self.cfg
        total = max_steps or cfg.TRAIN_TOTAL_STEPS
        primary = distributed.is_primary()
        logger = (MetricsLogger(cfg.result_dirs()["log"], tb=cfg.TRAIN_TBLOG)
                  if primary else None)
        epoch, done = self.data_pos
        t0 = time.time()
        while self.step < total:
            for batch in batcher.epoch(epoch, start=done):
                self.run_key, key = prng.next_step_key(self.run_key)
                metrics = self.train_step(batch, key)
                done += 1
                self.data_pos = (epoch, done)
                step = self.step
                if callback is not None:
                    callback(step, metrics)
                if primary and (step % log_every == 0 or step == 1
                                or step >= total):
                    loss = float(metrics["loss"])
                    iou = float(metrics["iou"])
                    lr = self.lr_fn(step)
                    dt = time.time() - t0
                    print(f"Itr:{step}, LR:{lr:.7f}, Time:{dt:.3f}, "
                          f"L:{loss:.3f} IoU:{iou:.3f}", flush=True)
                    logger.log(step, {"loss": loss, "iou": iou, "lr": lr,
                                      "grad_norm": float(metrics["grad_norm"]),
                                      "step_time": dt / max(1, log_every)})
                    if cfg.TRAIN_IMG_LOG:
                        logger.log_images(step, _train_log_images(
                            batch, metrics["pred"][0].cpu().numpy()))
                    t0 = time.time()
                if ckpt_dir and ((save_every and step % save_every == 0)
                                 or step >= total):
                    if primary:
                        self.save(ckpt_dir)
                    distributed.barrier()
                if step >= total:
                    break
            else:
                epoch, done = epoch + 1, 0
                self.data_pos = (epoch, done)
        if logger is not None:
            logger.close()
        return self
