"""Streaming evaluator — the RPA (reliable proxy augmentation) loop
(PyTorch port of ``rvos_tpu/engine/eval.py``, single scale, no flip,
frame by frame).

Per video: frame 0's ground truth fills the pinned bank slot 0; every
later frame is embedded, matched against the bank and the previous
frame, decoded, upsampled to the original size and soft-maxed; the
prediction takes the argmax over existing labels, and pixels whose
Shannon entropy exceeds ``UNC_RATIO`` are stored as label 125 (excluded
from matching) when the frame joins the bank every ``MEM_EVERY``
frames.  Mid-video ground truth (``current_label`` at frame > 0) is
spliced into the prediction (``join_label``).  The bank is a fixed ring
of ``TEST_BANK_CAPACITY`` slots; its flattened, occupancy-compacted
form is rebuilt only when the bank or the object set changes.

The k-means init scores of frame ``f`` come from a ``torch.Generator``
seeded with ``KMEANS_SEED + f`` (the JAX evaluator folds the frame index
into ``PRNGKey(42)``), unless the caller supplies ``kmeans_scores``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import Config
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, eval_variants, frame_u8
from ..device import compute_dtype, configure_precision, resolve_device
from ..models import AOCNet, DecoderMemory, precompact_bank
from ..ops.entropy import shannon_entropy
from ..ops.kmeans import draw_init_scores
from ..ops.resize import resize_nchw
from ..utils.image import save_mask

UNCERTAIN_LABEL = 125
KMEANS_SEED = 42

ScoreFn = Callable[[int, int, int], torch.Tensor]


def one_hot(lab: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over the last axis; labels outside [0, n) (the uncertain
    125, void 255) give all-zero rows."""
    return (lab[..., None] == torch.arange(n, device=lab.device)).to(dtype)


class _SeqState:
    """Per-video streaming state (device tensors)."""

    def __init__(self, capacity, emb, lab):
        h, w, c = emb.shape
        self.ref_emb = emb.new_zeros((capacity, h, w, c))
        self.ref_lab = torch.zeros((capacity, h, w), dtype=torch.long,
                                   device=emb.device)
        self.slot_valid = torch.zeros(capacity, device=emb.device)
        self.capacity = capacity
        self.ring_ptr = 1           # slot 0 pinned to the first frame
        self.version = 0
        self.flat = None            # (flat_emb, flat_lab, tile_obj)
        self.flat_key = None
        self.memory = DecoderMemory()
        self.add_ref(emb, lab, first=True)
        self.prev_emb, self.prev_lab = emb, lab

    def add_ref(self, emb, lab, first=False):
        if first:
            slot = 0
        else:
            slot = self.ring_ptr
            self.ring_ptr = self.ring_ptr + 1 if self.ring_ptr + 1 < self.capacity else 1
        self.ref_emb[slot] = emb
        self.ref_lab[slot] = lab
        self.slot_valid[slot] = 1.0
        self.version += 1


class Evaluator:
    # the model's config drives segment_frame; the evaluator prepares the
    # bank with its own — they must agree on these
    _MODEL_CFG_FIELDS = (
        "MATCHING_MAX_REF_PIXELS", "MATCHING_SEGMENTED_BANK",
        "MATCHING_OCCUPANCY_BANK", "MATCHING_DTYPE", "MODEL_FLOAT16_MATCHING",
        "TEST_GLOBAL_ATROUS_RATE", "TEST_LOCAL_ATROUS_RATE",
        "MODEL_MAX_OBJ_NUM", "MODEL_CLUSTER_NUM", "MODEL_KMEANS_ITERS")

    def __init__(self, cfg: Config, model: AOCNet, device=None,
                 kmeans_scores: Optional[ScoreFn] = None):
        """``model`` is moved to ``device`` (CUDA unless "cpu") and the
        eval compute dtype in place.  ``kmeans_scores(frame_idx, n_obj,
        n_rows)`` optionally supplies each frame's ``[O, R]`` k-means
        init scores."""
        for f in self._MODEL_CFG_FIELDS:
            if getattr(model.cfg, f) != getattr(cfg, f):
                raise ValueError(f"Evaluator cfg.{f}={getattr(cfg, f)!r} but "
                                 f"the model was built with "
                                 f"{getattr(model.cfg, f)!r}")
        if cfg.TEST_FLIP or tuple(cfg.TEST_MULTISCALE) != (1.0,):
            raise NotImplementedError(
                "the multi-scale/flip ensemble is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        configure_precision(cfg)
        self.dtype = compute_dtype(cfg, self.device)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.mem_every = cfg.MEM_EVERY
        self.unc_ratio = cfg.UNC_RATIO
        self.kmeans_scores = kmeans_scores
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self._last_state: Optional[_SeqState] = None   # introspection

    def _mem_boundary(self, frame_idx: int) -> bool:
        return self.mem_every > 0 and frame_idx % self.mem_every == 0

    def _init_scores(self, frame_idx: int, n_rows: int) -> torch.Tensor:
        o = self.cfg.MODEL_MAX_OBJ_NUM
        if self.kmeans_scores is not None:
            s = self.kmeans_scores(frame_idx, o, n_rows)
            return torch.as_tensor(s, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(KMEANS_SEED + frame_idx)
        return draw_init_scores(o, n_rows, gen, self.device)

    def _embed(self, img: np.ndarray):
        x = torch.from_numpy(frame_u8(img)).to(self.device)
        x = (x.float() / 255.0 - self._mean) / self._std
        emb, low = self.model.extract_feature(x[None].to(self.dtype))
        return emb[0], low[0]

    def _ensure_flat(self, st: _SeqState, obj_valid: torch.Tensor, key):
        if st.flat_key == key:
            return
        onehot = one_hot(st.ref_lab, self.cfg.MODEL_MAX_OBJ_NUM, self.dtype)
        onehot = onehot * obj_valid.to(self.dtype)
        st.flat = precompact_bank(self.cfg, st.ref_emb, onehot, st.slot_valid)
        st.flat_key = key

    def _step(self, img, st: _SeqState, obj_valid, exist, frame_idx, ori_hw,
              join_label):
        """One frame → (pred [H, W] uint8, and the state updated)."""
        o = self.cfg.MODEL_MAX_OBJ_NUM
        emb, low = self._embed(img)
        h, w = emb.shape[:2]
        flat_emb, flat_lab, tile_obj = st.flat
        logits, st.memory = self.model.segment_frame(
            emb, low, st.ref_emb, one_hot(st.ref_lab, o, self.dtype),
            st.slot_valid, st.prev_emb, one_hot(st.prev_lab, o, self.dtype),
            obj_valid, st.memory, self._init_scores(frame_idx, flat_emb.shape[0]),
            flat_emb, flat_lab, tile_obj)
        lg = resize_nchw(logits.float(), ori_hw, "bilinear")
        probs = torch.softmax(lg, dim=0) * exist[:, None, None]
        pred = probs.argmax(dim=0)
        unc = shannon_entropy(probs, exist)
        if join_label is not None:
            pred = torch.where(join_label == 0, pred, join_label)
        conf = torch.where(unc > self.unc_ratio,
                           torch.full_like(pred, UNCERTAIN_LABEL), pred)
        if join_label is not None:
            conf = torch.where(join_label == 0, conf, join_label)
        st.prev_emb = emb
        st.prev_lab = resize_nchw(pred, (h, w), "nearest")
        if join_label is not None or self._mem_boundary(frame_idx):
            st.add_ref(emb, resize_nchw(conf, (h, w), "nearest"))
        return pred.to(torch.uint8)

    @torch.no_grad()
    def evaluate_sequence(self, seq, save_dir: Optional[str] = None,
                          frame_callback: Optional[Callable[[int], None]] = None
                          ) -> Dict:
        """Stream one video.  Returns ``{"results": {frame name: uint8
        mask}, "fps", "frames", "time"}``; frame 0 (the given ground
        truth) has no result.  ``frame_callback(frame_idx)`` runs after
        each frame's work is issued."""
        cfg = self.cfg
        o = cfg.MODEL_MAX_OBJ_NUM
        st: Optional[_SeqState] = None
        label_all: List[int] = []
        preds = []
        t0 = time.time()
        for frame_idx in range(len(seq)):
            sample = seq[frame_idx]
            meta = sample["meta"]
            ori_hw = (meta["height"], meta["width"])
            gt = sample.get("current_label")
            gt_all = sample.get("current_label_all")
            if frame_idx == 0 and gt is None:
                raise ValueError(f"sequence {meta.get('seq_name', '?')}: the "
                                 "first frame has no 'current_label'")
            (var,) = eval_variants(sample["current_img"], cfg.TEST_MAX_SIZE,
                                   cfg.TEST_MIN_SIZE, False, (1.0,))
            ov_np = (np.arange(o) <= int(meta["obj_num"])).astype(np.float32)
            for lab in (gt, gt_all):
                if lab is not None:
                    for lid in np.unique(lab).tolist():
                        if lid != 255 and lid not in label_all:
                            if lid >= o:
                                raise ValueError(
                                    f"object id {lid} >= MODEL_MAX_OBJ_NUM={o}")
                            label_all.append(lid)
            exist_np = np.zeros(o, np.float32)
            exist_np[label_all] = 1.0

            if frame_idx == 0:
                emb, _ = self._embed(var["img"])
                lab = torch.from_numpy(gt.astype(np.int64)).to(self.device)
                st = _SeqState(cfg.TEST_BANK_CAPACITY, emb,
                               resize_nchw(lab, emb.shape[:2], "nearest"))
            else:
                obj_valid = torch.from_numpy(ov_np).to(self.device)
                self._ensure_flat(st, obj_valid, (st.version, tuple(ov_np)))
                join = None
                if gt is not None:
                    join = torch.from_numpy(gt.astype(np.int64)).to(self.device)
                pred = self._step(var["img"], st, obj_valid,
                                  torch.from_numpy(exist_np).to(self.device),
                                  frame_idx, ori_hw, join)
                preds.append((meta["current_name"], pred))
            if frame_callback is not None:
                frame_callback(frame_idx)
        self._last_state = st
        results = {name: p.cpu().numpy() for name, p in preds}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seq_time = time.time() - t0
        if save_dir is not None:
            for name, mask in results.items():
                save_mask(mask, os.path.join(
                    save_dir, os.path.splitext(name)[0] + ".png"))
        return {"results": results, "frames": len(preds), "time": seq_time,
                "fps": len(preds) / max(seq_time, 1e-6)}

    def evaluating(self, dataset, save_root: Optional[str] = None,
                   verbose: bool = True) -> Dict:
        """Every sequence of ``dataset``, with the reference's FPS lines."""
        total_time, total_frames, total_sfps = 0.0, 0, 0.0
        per_seq = {}
        for i in range(len(dataset)):
            seq = dataset[i]
            save_dir = None
            if save_root is not None:
                save_dir = os.path.join(save_root, seq.seq_name)
            out = self.evaluate_sequence(seq, save_dir)
            per_seq[seq.seq_name] = out["fps"]
            total_time += out["time"]
            total_frames += out["frames"]
            total_sfps += out["fps"]
            if verbose:
                print(f"Seq {seq.seq_name} FPS: {out['fps']:.2f}, Total FPS: "
                      f"{total_frames / max(total_time, 1e-6):.2f}, FPS per "
                      f"Seq: {total_sfps / (i + 1):.2f}")
        return {"per_seq_fps": per_seq,
                "total_fps": total_frames / max(total_time, 1e-6)}
