"""Datasets (the port's own copy of ``rvos_tpu/data/datasets.py``).

Training: ``VOSTrain`` samples a reference frame (up to five tries for
one with more than 200 foreground pixels), a previous frame and
``curr_len`` frames at random gaps (indices reflect-padded at the ends),
optionally reversed, with up to five retries for a reference frame that
holds every object of the others; ``DAVISTrain`` (``ImageSets/2017``
splits, repeated ``repeat_time`` times) and ``YTBVOSTrain``
(``meta.json``, objects seen on fewer than two frames skipped) read the
trees; ``SyntheticTrain`` makes fake clips from a seed.  Each item draws
from a generator seeded by (seed, epoch, index) when a seed is given,
so it does not depend on which loader thread reads it, and equals the
JAX package's item.

Evaluation:

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


class VOSTrain:
    def __init__(self, image_root, label_root, imglistdic, transform=None,
                 rgb=True, repeat_time=1, rand_gap=3, curr_len=3,
                 rand_reverse=True, seed=None, image_dtype=np.float32):
        self.image_root = image_root
        self.label_root = label_root
        self.imglistdic = imglistdic
        self.transform = transform
        self.rgb = rgb
        self.image_dtype = image_dtype
        self.repeat_time = repeat_time
        self.rand_gap = rand_gap
        self.curr_len = curr_len
        self.rand_reverse = rand_reverse
        self.seqs = list(imglistdic.keys())
        self.seed = seed
        self.epoch = 0          # folded into the per-item rng (set_epoch)

    def set_epoch(self, epoch_idx: int):
        self.epoch = int(epoch_idx)

    def __len__(self):
        return int(len(self.seqs) * self.repeat_time)

    def _get_image_label(self, seqname, imagelist, lablist, index):
        image = _read_image(os.path.join(self.image_root, seqname,
                                         imagelist[index]), self.rgb,
                            dtype=self.image_dtype)
        label = _read_label(os.path.join(self.label_root, seqname,
                                         lablist[index]))
        return image, label

    @staticmethod
    def _check_index(total_len, index):
        """Reflect an index past either end back into the sequence."""
        if total_len <= 1:
            return 0
        while index < 0 or index >= total_len:
            if index < 0:
                index = -index
            else:
                index = 2 * (total_len - 1) - index
        return index

    def _ref_index(self, rng, seqname, lablist, min_fg_pixels=200,
                   max_try=5):
        ref_index = 0
        for _ in range(max_try):
            ref_index = int(rng.integers(len(lablist)))
            lab = _read_label(os.path.join(self.label_root, seqname,
                                           lablist[ref_index]))
            if np.count_nonzero(lab) > min_fg_pixels:
                break
        return ref_index

    def __getitem__(self, idx):
        rng = (np.random.default_rng((self.seed, self.epoch, int(idx)))
               if self.seed is not None else np.random.default_rng())
        seqname = self.seqs[idx % len(self.seqs)]
        imagelist, lablist = self.imglistdic[seqname]
        frame_num = len(imagelist)
        if self.rand_reverse and rng.integers(2) == 1:
            imagelist, lablist = imagelist[::-1], lablist[::-1]

        sample = None
        for _ in range(5):
            gaps = [int(rng.integers(self.rand_gap) + 1)
                    for _ in range(self.curr_len)]
            search = len(lablist) - sum(gaps)
            prev_index = int(rng.integers(search)) if search > 1 else 0
            prev_img, prev_lab = self._get_image_label(
                seqname, imagelist, lablist, prev_index)

            curr_imgs, curr_labs, objs = [], [], set(np.unique(prev_lab))
            now = prev_index
            for gap in gaps:
                now += gap
                ci = self._check_index(len(lablist), now)
                im, la = self._get_image_label(seqname, imagelist, lablist, ci)
                curr_imgs.append(im)
                curr_labs.append(la)
                objs |= set(np.unique(la))

            ref_index = self._ref_index(rng, seqname, lablist)
            ref_img, ref_lab = self._get_image_label(
                seqname, imagelist, lablist, ref_index)
            ref_objs = set(np.unique(ref_lab))
            sample = (ref_img, ref_lab, prev_img, prev_lab, curr_imgs,
                      curr_labs, ref_objs)
            if all(o in ref_objs for o in objs if o != 0):
                break

        ref_img, ref_lab, prev_img, prev_lab, curr_imgs, curr_labs, \
            ref_objs = sample
        out = {
            "ref_img": ref_img, "prev_img": prev_img, "curr_img": curr_imgs,
            "ref_label": ref_lab, "prev_label": prev_lab,
            "curr_label": curr_labs,
            "meta": {"seq_name": seqname, "frame_num": frame_num,
                     "obj_num": int(max(ref_objs))},
        }
        if self.transform is not None:
            out = self.transform(out)
        return out


class DAVISTrain(VOSTrain):
    def __init__(self, root, split=("train",), transform=None,
                 full_resolution=False, repeat_time=30, rand_gap=3,
                 curr_len=3, rand_reverse=True, rgb=True, seed=None,
                 image_dtype=np.float32):
        resolution = "480p"
        if full_resolution:
            resolution = "Full-Resolution"
            if not os.path.exists(os.path.join(root, "JPEGImages",
                                               resolution)):
                print("No Full-Resolution, use 480p instead.")
                resolution = "480p"
        image_root = os.path.join(root, "JPEGImages", resolution)
        label_root = os.path.join(root, "Annotations", resolution)
        seq_names = []
        for sp in split:
            with open(os.path.join(root, "ImageSets", "2017",
                                   sp + ".txt")) as f:
                seq_names.extend(x.strip() for x in f if x.strip())
        imglistdic = {}
        for seq in seq_names:
            images = sorted(os.listdir(os.path.join(image_root, seq)))
            labels = sorted(os.listdir(os.path.join(label_root, seq)))
            imglistdic[seq] = (images, labels)
        super().__init__(image_root, label_root, imglistdic, transform, rgb,
                         repeat_time, rand_gap, curr_len, rand_reverse, seed,
                         image_dtype)


class YTBVOSTrain(VOSTrain):
    def __init__(self, root, transform=None, rand_gap=3, curr_len=3,
                 rand_reverse=True, rgb=True, seed=None,
                 image_dtype=np.float32):
        image_root = os.path.join(root, "JPEGImages")
        label_root = os.path.join(root, "Annotations")
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)["videos"]
        imglistdic = {}
        for seq, info in meta.items():
            frames = set()
            for obj in info["objects"].values():
                if len(obj["frames"]) >= 2:
                    frames.update(obj["frames"])
            frames = sorted(frames)
            if len(frames) >= 2:
                imglistdic[seq] = ([f + ".jpg" for f in frames],
                                   [f + ".png" for f in frames])
        super().__init__(image_root, label_root, imglistdic, transform, rgb,
                         1, rand_gap, curr_len, rand_reverse, seed,
                         image_dtype)


class SyntheticTrain:
    """Fake clips for a full training run with no dataset: random frames
    from (seed, index), ``obj_num`` horizontal bands as objects."""

    def __init__(self, size=(465, 465), curr_len=3, length=3000,
                 transform=None, obj_num=2, seed=0):
        self.size = size
        self.curr_len = curr_len
        self.length = length
        self.transform = transform
        self.obj_num = obj_num
        self.seed = seed

    def __len__(self):
        return self.length

    def _frame(self, rng):
        h, w = self.size
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        lab = np.zeros((h, w), np.uint8)
        for o in range(1, self.obj_num + 1):
            y = (h // (self.obj_num + 1)) * o
            lab[y - h // 8: y + h // 8, w // 4: 3 * w // 4] = o
        return img, lab

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, int(idx)))
        ref_img, ref_lab = self._frame(rng)
        prev_img, prev_lab = self._frame(rng)
        currs = [self._frame(rng) for _ in range(self.curr_len)]
        sample = {
            "ref_img": ref_img, "prev_img": prev_img,
            "curr_img": [c[0] for c in currs],
            "ref_label": ref_lab, "prev_label": prev_lab,
            "curr_label": [c[1] for c in currs],
            "meta": {"seq_name": f"fake{idx}", "frame_num": 10,
                     "obj_num": self.obj_num},
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


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
