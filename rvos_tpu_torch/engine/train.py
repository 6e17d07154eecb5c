"""Training on one GPU (PyTorch port of ``rvos_tpu/engine/train.py``).

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

Then the optimizer (``learning.TrainOptimizer``): the global norm of
every gradient, the non-finite skip (parameters and optimizer state
untouched; the step counter still advances), clip, decay, nesterov SGD.

k-means draws the JAX trainer's own scores (``ops.prng``): the run key
``PRNGKey(1234)`` is split once per step.  A fresh run sees the JAX
package's draws and data order; a resumed run continues both where the
checkpoint left them (the JAX trainer restarts them at resume).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs import Config
from ..device import configure_precision, resolve_device
from ..models import AOCNet, DecoderMemory
from ..ops import prng
from ..ops.resize import resize_nchw
from ..weights import init_random_
from .learning import TrainOptimizer, lr_schedule
from .loss import batched_iou, hard_mining_ce


def check_train_config(cfg: Config, device: torch.device) -> None:
    """Raise for what this port does not train yet, naming its ROADMAP
    item, instead of running something else."""
    if cfg.TRAIN_COMPUTE_DTYPE != "float32" or cfg.matching_dtype == "bfloat16":
        raise NotImplementedError(
            "bfloat16 training (TRAIN_COMPUTE_DTYPE='bfloat16', --float16, "
            "bfloat16 matching) is not ported: ROADMAP Queue A item 7e")
    if cfg.MESH_MODEL_AXIS > 1:
        raise NotImplementedError(
            "context-parallel training (MESH_MODEL_AXIS > 1) is not "
            "ported: ROADMAP Queue A item 8")
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if min(cfg.MESH_DATA_AXIS, n_dev) > 1:
        raise NotImplementedError(
            f"a data mesh of {min(cfg.MESH_DATA_AXIS, n_dev)} devices: "
            "multi-GPU training is ROADMAP Queue A item 8 (set "
            "MESH_DATA_AXIS=1 or --gpu_num 1)")
    if cfg.MODEL_BACKBONE != "resnet":
        raise NotImplementedError(
            f"backbone {cfg.MODEL_BACKBONE!r}: MobileNet is ROADMAP Queue "
            "A item 6")


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


def make_train_step(cfg: Config, model: AOCNet, optimizer: TrainOptimizer):
    """``train_step(batch, step, key, seeds)`` → metrics, with the loss
    as ``train_step.loss_fn(batch, step, key, seeds)`` → ``(loss,
    (losses [T], ious [T], last prediction or None))``.  ``batch``: the
    ``TrainBatcher`` dict on the model's device; ``key``: this step's
    key ([2] int64); ``seeds``: three dropout seeds (ref, prev, current
    frames) or None (no dropout)."""
    o = min(cfg.DATA_MAX_OBJ_NUM + 1, cfg.MODEL_MAX_OBJ_NUM)
    remat = cfg.TRAIN_REMAT

    def extract(imgs, seed):
        gen = None
        if seed is not None and cfg.MODEL_ASPP_DROPOUT > 0:
            gen = torch.Generator(device=imgs.device).manual_seed(seed)
        return model.extract_feature(_normalize(imgs), gen)

    def run_extract(imgs, seed):
        if remat:
            return checkpoint(extract, imgs, seed, use_reentrant=False)
        return extract(imgs, seed)

    def frame(step, cur_emb, cur_low, cur_lab_full, ref_emb, ref_onehot,
              prev_e, prev_l, obj_valid, slots, valid, scores):
        """One rollout frame for every item → (mean mined CE, full-res
        prediction, new memory slots and flags)."""
        one = torch.ones(1, device=cur_emb.device)
        logits, new_slots, new_valid = [], [], []
        for b in range(cur_emb.shape[0]):
            lg, mem = model.segment_frame(
                cur_emb[b], cur_low[b], ref_emb[b][None], ref_onehot[b][None],
                one, prev_e[b], _onehot(prev_l[b], o), obj_valid[b],
                DecoderMemory(slots[b], valid[b]), scores[b], train=True)
            logits.append(lg)
            new_slots.append(mem.slots)
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

    def loss_fn(batch, step: int, key: torch.Tensor, seeds=None):
        seeds = seeds if seeds is not None else (None, None, None)
        ref_emb, _ = run_extract(batch["ref_img"], seeds[0])
        prev_emb, _ = run_extract(batch["prev_img"], seeds[1])
        b, h, w, _ = ref_emb.shape
        hw = (h, w)
        t_len = batch["curr_img"].shape[0]
        dev = ref_emb.device

        ref_lab = _downscale_labels(batch["ref_label"], hw)
        prev_lab = _downscale_labels(batch["prev_label"], hw)
        obj_valid = (torch.arange(o, device=dev)[None]
                     <= batch["obj_num"][:, None]).float()
        ref_onehot = _onehot(ref_lab, o)
        slots = torch.zeros((b, 2, o, cfg.MODEL_HEAD_EMBEDDING_DIM,
                             (h + 1) // 2, (w + 1) // 2), device=dev)
        valid = torch.zeros((b, 2), dtype=torch.bool, device=dev)

        curr = batch["curr_img"]
        embs, lows = run_extract(curr.reshape((-1,) + curr.shape[2:]),
                                 seeds[2])
        embs = embs.reshape((t_len, b) + embs.shape[1:])
        lows = lows.reshape((t_len, b) + lows.shape[1:])
        scores = prng.train_kmeans_scores(key, t_len, b, o,
                                          bank_rows(cfg, hw), dev)

        prev_e, prev_gt, prev_pred = prev_emb, prev_lab, prev_lab
        use_pred = step > cfg.TRAIN_START_SEQ_TRAINING_STEPS
        losses, ious, pred_full = [], [], None
        for t in range(t_len):
            if cfg.TRAIN_SEQ_GRADIENT == "detach":
                prev_e = prev_e.detach()
            args = (step, embs[t], lows[t], batch["curr_label"][t], ref_emb,
                    ref_onehot, prev_e, prev_pred if use_pred else prev_gt,
                    obj_valid, slots, valid, scores[t])
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

    def train_step(batch, step: int, key: torch.Tensor, seeds=None) -> Dict:
        optimizer.zero_grad()
        loss, (losses, ious, last) = loss_fn(batch, step, key, seeds)
        loss.backward()
        res = optimizer.step()
        return {"loss": loss.detach(), "seq_losses": losses.detach(),
                "iou": ious.mean(), "grad_norm": res["grad_norm"],
                "applied": res["applied"], "pred": last}

    train_step.loss_fn = loss_fn
    return train_step


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
    """One-GPU trainer: model and optimizer, auto-resume, explicit
    resume or a pretrained warm start, and ``fit``.

    ``device``: CUDA unless ``"cpu"`` is asked for (raises without a
    card).  ``init_state``: a state dict to start from (e.g. the JAX
    package's parameters through ``weights.from_jax_params``), else
    random weights from ``torch.Generator().manual_seed(seed)``; the
    same seed drives the dropout draws."""

    def __init__(self, cfg: Config, device=None,
                 init_state: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_train_config(cfg, self.device)
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
        self._step_fn = make_train_step(cfg, self.model, self.optimizer)
        self._process_pretrained_model()

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
    def train_step(self, batch: Dict[str, np.ndarray], key: torch.Tensor
                   ) -> Dict:
        seeds = [int(s) for s in torch.randint(
            0, 2 ** 62, (3,), generator=self.dropout_gen)]
        metrics = self._step_fn(batch_to_device(batch, self.device),
                                self.step, key.to(self.device), seeds)
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
        runs after each step (measurement scripts time steps with it)."""
        from ..utils.logging import MetricsLogger
        cfg = self.cfg
        total = max_steps or cfg.TRAIN_TOTAL_STEPS
        logger = MetricsLogger(cfg.result_dirs()["log"], tb=cfg.TRAIN_TBLOG)
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
                if step % log_every == 0 or step == 1 or step >= total:
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
                    self.save(ckpt_dir)
                if step >= total:
                    break
            else:
                epoch, done = epoch + 1, 0
                self.data_pos = (epoch, done)
        logger.close()
        return self
