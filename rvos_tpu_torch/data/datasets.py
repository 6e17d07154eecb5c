"""Synthetic eval fixture (the port's own copy of
``rvos_tpu/data/datasets.py::SyntheticEval``): fake sequences of random
frames with first-frame ground truth — a streaming-eval smoke test with
random weights.  The same ``seed`` gives the same frames as the JAX
package's fixture."""

from __future__ import annotations

import numpy as np


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
