"""Eval datasets (the port's own copy of the eval side of
``rvos_tpu/data/datasets.py``).

* ``VOSTestSeq``: one video streamed frame by frame, with the object
  count and list growing as objects are first annotated, non-contiguous
  raw ids (e.g. {1, 13}) compacted in order of appearance
  (``label_convert``; the evaluator writes masks back through
  ``label_backward``; 255, the DAVIS void label, is never remapped),
  every frame's ground truth as ``current_label_all`` when
  ``all_labels`` is set (used only to mask channels, never spliced), and
  ``frame_transform`` (a Robust-VOS perturbation, ``data.perturb``)
  applied to each decoded frame.
* ``DAVISTest`` (DAVIS 2016/2017: ``ImageSets/<year>/<split>.txt``,
  ``JPEGImages``/``Annotations`` at 480p or full resolution; the first
  frame's mask is the only one spliced) and ``YTBVOSTest`` (YouTube-VOS:
  ``meta.json``, or ``meta_all.json`` and every frame with ``use_all``;
  masks of objects that appear mid-video are spliced on their frame).
* ``SyntheticEval``: fake sequences of random frames with first-frame
  ground truth; the same ``seed`` gives the JAX package's frames.

Frames are decoded with PIL, as the JAX package decodes them where cv2
is absent; PIL is imported only when a file is read.  A frame stays
uint8 unless a ``frame_transform`` is set (then float32, as the
transform expects).  The evaluator resizes frames itself
(``transforms.eval_variants``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Callable, List, Optional

import numpy as np


def _read_image(path: str, rgb: bool = True, dtype=np.float32) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), dtype=dtype)
    return img if rgb else np.ascontiguousarray(img[:, :, ::-1])


def _read_label(path: str) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path), dtype=np.uint8)


class VOSTestSeq:
    """One eval sequence: frames, the sparse labels that annotate objects
    (the evaluator splices them on their frames), and the incremental
    object bookkeeping."""

    def __init__(self, image_root, label_root, seq_name, images, labels,
                 rgb=True, single_obj=False,
                 frame_transform: Optional[Callable] = None,
                 all_labels: bool = False):
        self.image_root = image_root
        self.label_root = label_root
        self.seq_name = seq_name
        self.images = images
        self.labels = labels
        self.rgb = rgb
        self.single_obj = single_obj
        self.frame_transform = frame_transform
        self.all_labels = all_labels
        label_set = set(labels)
        self.obj_nums: List[int] = []
        self.obj_lists: List[List[int]] = []
        cur_objs: List[int] = []
        cur_num = 0
        for img in images:
            lab_name = os.path.splitext(img)[0] + ".png"
            if lab_name in label_set:
                lab = _read_label(os.path.join(label_root, seq_name, lab_name))
                if single_obj:
                    lab = (lab > 0).astype(np.uint8)
                ids = [int(x) for x in np.unique(lab) if x != 0]
                for i in ids:
                    if i not in cur_objs:
                        cur_objs.append(i)
                cur_num = max([cur_num] + ids) if ids else cur_num
            self.obj_nums.append(cur_num)
            self.obj_lists.append(list(cur_objs))

        self.label_convert: Optional[dict] = None
        self.label_backward: Optional[np.ndarray] = None
        self._fwd_lut: Optional[np.ndarray] = None
        raw_ids = [r for r in cur_objs if r != 255]
        if raw_ids and raw_ids != list(range(1, len(raw_ids) + 1)):
            self.label_convert = {r: i + 1 for i, r in enumerate(raw_ids)}
            fwd = np.arange(256, dtype=np.uint8)
            bwd = np.arange(256, dtype=np.uint8)
            for r, c in self.label_convert.items():
                fwd[r] = c
                bwd[c] = r
            self._fwd_lut, self.label_backward = fwd, bwd
            self.obj_lists = [
                [self.label_convert[r] for r in ol if r != 255]
                for ol in self.obj_lists]
            self.obj_nums = [max(ol) if ol else 0 for ol in self.obj_lists]

    def __len__(self):
        return len(self.images)

    def _label(self, path: str) -> np.ndarray:
        lab = _read_label(path)
        if self.single_obj:
            return (lab > 0).astype(np.uint8)
        if self._fwd_lut is not None:
            return self._fwd_lut[lab]
        return lab

    def __getitem__(self, idx):
        img_name = self.images[idx]
        dt = np.float32 if self.frame_transform is not None else np.uint8
        img = _read_image(os.path.join(self.image_root, self.seq_name,
                                       img_name), self.rgb, dtype=dt)
        if self.frame_transform is not None:
            img = self.frame_transform(img)
        h, w = img.shape[:2]
        sample = {
            "current_img": img,
            "meta": {"seq_name": self.seq_name, "frame_num": len(self.images),
                     "obj_num": self.obj_nums[idx],
                     "obj_list": self.obj_lists[idx],
                     "current_name": img_name, "height": h, "width": w},
        }
        lab_name = os.path.splitext(img_name)[0] + ".png"
        lab_path = os.path.join(self.label_root, self.seq_name, lab_name)
        if lab_name in self.labels:
            lab = self._label(lab_path)
            sample["current_label"] = lab
            if self.all_labels:
                sample["current_label_all"] = lab
        elif self.all_labels and os.path.exists(lab_path):
            sample["current_label_all"] = self._label(lab_path)
        return sample


def _perturbation(image_type: int, frame_transform, perturb_seed: int):
    if image_type and frame_transform is None:
        from .perturb import get_perturbation
        return get_perturbation(image_type,
                                np.random.default_rng(perturb_seed))
    return frame_transform


class DAVISTest:
    """DAVIS 2016/2017 eval sequences; ``all_labels`` surfaces every
    frame's ground truth as ``current_label_all``; ``image_type`` 1-9
    picks a perturbation when no ``frame_transform`` is given."""

    def __init__(self, root, split=("val",), year=2017, full_resolution=False,
                 rgb=True, frame_transform=None, all_labels=False,
                 image_type: int = 0, perturb_seed: int = 0):
        resolution = "Full-Resolution" if full_resolution else "480p"
        self.image_root = os.path.join(root, "JPEGImages", resolution)
        self.label_root = os.path.join(root, "Annotations", resolution)
        self.single_obj = year == 2016
        self.rgb = rgb
        self.frame_transform = _perturbation(image_type, frame_transform,
                                             perturb_seed)
        self.all_labels = all_labels
        self.seqs: List[str] = []
        for sp in split:
            with open(os.path.join(root, "ImageSets", str(year),
                                   sp + ".txt")) as f:
                self.seqs.extend(x.strip() for x in f if x.strip())

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx):
        seq = self.seqs[idx]
        images = sorted(os.listdir(os.path.join(self.image_root, seq)))
        labels = [os.path.splitext(images[0])[0] + ".png"]
        return VOSTestSeq(self.image_root, self.label_root, seq, images,
                          labels, self.rgb, self.single_obj,
                          self.frame_transform, all_labels=self.all_labels)


class YTBVOSTest:
    """YouTube-VOS eval sequences from ``meta.json`` (``use_all``:
    ``meta_all.json`` and every frame of the image directory); with
    ``result_root`` each sequence's first annotation is copied into the
    result tree, which the benchmark server requires."""

    def __init__(self, root, rgb=True, use_all=False, frame_transform=None,
                 result_root=None, image_type: int = 0, perturb_seed: int = 0,
                 all_labels=False):
        self.frame_transform = _perturbation(image_type, frame_transform,
                                             perturb_seed)
        self.all_labels = all_labels
        self.image_root = os.path.join(root, "JPEGImages")
        self.label_root = os.path.join(root, "Annotations")
        meta_name = "meta_all.json" if use_all and os.path.exists(
            os.path.join(root, "meta_all.json")) else "meta.json"
        with open(os.path.join(root, meta_name)) as f:
            self.meta = json.load(f)["videos"]
        self.seqs = sorted(self.meta.keys())
        self.rgb = rgb
        self.use_all = use_all
        self.result_root = result_root

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx):
        seq = self.seqs[idx]
        info = self.meta[seq]["objects"]
        if self.use_all:
            images = sorted(os.listdir(os.path.join(self.image_root, seq)))
        else:
            frames = set()
            for obj in info.values():
                frames.update(obj["frames"])
            images = [f + ".jpg" for f in sorted(frames)]
        labels = sorted(os.listdir(os.path.join(self.label_root, seq)))
        seq_ds = VOSTestSeq(self.image_root, self.label_root, seq, images,
                            labels, self.rgb, False, self.frame_transform,
                            all_labels=self.all_labels)
        if self.result_root is not None and labels:
            dst = os.path.join(self.result_root, seq)
            os.makedirs(dst, exist_ok=True)
            src = os.path.join(self.label_root, seq, labels[0])
            if os.path.exists(src):
                shutil.copy(src, os.path.join(dst, labels[0]))
        return seq_ds


class SyntheticEval:
    def __init__(self, size=(129, 129), n_seqs=3, n_frames=10, obj_num=2,
                 frame_transform=None, seed=0):
        self.size = size
        self.n_seqs = n_seqs
        self.n_frames = n_frames
        self.obj_num = obj_num
        self.frame_transform = frame_transform
        self.seed = seed

    def __len__(self):
        return self.n_seqs

    def __getitem__(self, idx):
        return _SyntheticSeq(f"test{idx + 1}", self.size, self.n_frames,
                             self.obj_num, self.frame_transform,
                             self.seed + idx)


class _SyntheticSeq:
    def __init__(self, seq_name, size, n_frames, obj_num, frame_transform,
                 seed):
        self.seq_name = seq_name
        self.size = size
        self.n_frames = n_frames
        self.obj_num = obj_num
        self.frame_transform = frame_transform
        self.seed = seed
        self.images = [f"{i:05d}.jpg" for i in range(n_frames)]

    def __len__(self):
        return self.n_frames

    def __getitem__(self, idx):
        h, w = self.size
        rng = np.random.default_rng((self.seed, int(idx)))
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        if self.frame_transform is not None:
            img = self.frame_transform(img)
        sample = {
            "current_img": img,
            "meta": {"seq_name": self.seq_name, "frame_num": self.n_frames,
                     "obj_num": self.obj_num,
                     "obj_list": list(range(1, self.obj_num + 1)),
                     "current_name": self.images[idx],
                     "height": h, "width": w},
        }
        if idx == 0:
            lab = np.zeros((h, w), np.uint8)
            for o in range(1, self.obj_num + 1):
                y = (h // (self.obj_num + 1)) * o
                lab[max(0, y - h // 8): y + h // 8, w // 4: 3 * w // 4] = o
            sample["current_label"] = lab
        return sample
