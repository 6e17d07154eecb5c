"""Videos of a traffic mix, made from the seed before the window.

The mix fixes the set of videos: ``videos`` lists each one's frame count,
object count and the frame at which each object's mask is first given
(0 for frame 0; a later frame is a join).  Every seed gets the same set
in another order (a permutation drawn from the seed), so a window does
the same kind of work on every seed; the seed also draws what the frames
show.  A frame is a textured background panning under the camera and
the objects as textured ellipses that drift and breathe, the later ones
on top; an object that joins late enters at its join frame.  Pixels are
made on the device in a few large calls and kept on the host as uint8,
as a decoder would hand them over.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


class Video:
    """One video: ``frames`` uint8 [T, H, W, 3]; ``labels`` {frame: uint8
    [H, W]} the masks given (frame 0, and each join frame with only its
    new objects); ``obj_num`` the objects of the video."""

    def __init__(self, name: str, frames: np.ndarray, labels: Dict[int, np.ndarray],
                 obj_num: int):
        self.name = name
        self.frames = frames
        self.labels = labels
        self.obj_num = obj_num

    def __len__(self):
        return self.frames.shape[0]


def order(mix: Dict, seed: int) -> List[int]:
    """The mix's videos in this seed's order."""
    rng = np.random.default_rng([seed % (2 ** 63), 1])
    return [int(i) for i in rng.permutation(len(mix["videos"]))]


def _texture(gen, n, c, h, w, cells, device):
    """n smooth random textures [n, c, h, w] in [0, 255]."""
    low = torch.rand((n, c, cells[0], cells[1]), generator=gen, device=device)
    x = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    fine = torch.rand((n, c, h, w), generator=gen, device=device)
    return (x * 200.0 + fine * 55.0).clamp(0, 255)


def render(spec, hw, seed: int, index: int, device, name: str,
           every_label: bool = False) -> Video:
    """The video of ``spec`` = [frames, objects, first frames] at ``hw``;
    with ``every_label`` every frame's full mask is given."""
    t_len, n_obj, first = int(spec[0]), int(spec[1]), list(spec[2])
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index * 7919 + 5) % (2 ** 63))
    margin = max(8, h // 12)
    bg = _texture(gen, 1, 3, h + 2 * margin, w + 2 * margin,
                  (max(2, h // 40), max(2, w // 40)), device)[0]
    tex = _texture(gen, n_obj, 3, h, w, (max(2, h // 60), max(2, w // 60)),
                   device)
    u = torch.rand((n_obj, 8), generator=gen, device=device).tolist()
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    pan = torch.rand(4, generator=gen, device=device).tolist()
    frames = torch.empty((t_len, h, w, 3), dtype=torch.uint8, device=device)
    labs = torch.zeros((t_len, h, w), dtype=torch.uint8, device=device)
    for t in range(t_len):
        ph = 2 * math.pi * t / max(t_len, 1)
        oy = int(margin + (margin - 1) * math.sin(ph + 6.28 * pan[0]))
        ox = int(margin + (margin - 1) * math.sin(ph * 0.7 + 6.28 * pan[1]))
        img = bg[:, oy:oy + h, ox:ox + w].clone()
        lab = torch.zeros((h, w), dtype=torch.uint8, device=device)
        for o in range(n_obj):
            if t < first[o]:
                continue
            cy = h * (0.2 + 0.6 * u[o][0]) + (u[o][2] - 0.5) * 0.4 * h * t / t_len
            cx = w * (0.2 + 0.6 * u[o][1]) + (u[o][3] - 0.5) * 0.4 * w * t / t_len
            breathe = 1.0 + 0.15 * math.sin(ph * 2 + 6.28 * u[o][6])
            ry = h * (0.07 + 0.15 * u[o][4]) * breathe
            rx = w * (0.05 + 0.12 * u[o][5]) * breathe
            inside = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1.0
            img = torch.where(inside[None], tex[o], img)
            lab = torch.where(inside, torch.full_like(lab, o + 1), lab)
        frames[t] = img.permute(1, 2, 0).round().to(torch.uint8)
        labs[t] = lab
    frames_np = frames.cpu().numpy()
    if every_label:
        return Video(name, frames_np, dict(enumerate(labs.cpu().numpy())),
                     n_obj)
    labels = {}
    for t in sorted(set(first)):
        if t >= t_len:
            continue
        new = [o + 1 for o in range(n_obj) if first[o] == t]
        lab = labs[t]
        keep = torch.zeros_like(lab, dtype=torch.bool)
        for o in new:
            keep |= lab == o
        labels[t] = torch.where(keep, lab, torch.zeros_like(lab)).cpu().numpy()
    return Video(name, frames_np, labels, n_obj)


def make_videos(mix: Dict, seed: int, device, limit: Optional[int] = None
                ) -> List[Video]:
    """The mix's videos in this seed's order (the first ``limit``)."""
    idx = order(mix, seed)[:limit]
    return [render(mix["videos"][i], mix["frame_hw"], seed, i, device,
                   f"v{i:03d}") for i in idx]


def warmup_spec(mix: Dict) -> List:
    """A short video that runs every kind of step the mix's videos run:
    frame 0, a full chunk (a graph capture), ragged frames and, where the
    mix has joins, a join frame."""
    joins = any(f > 0 for _, _, firsts in mix["videos"] for f in firsts)
    return [13, 2, [0, 8 if joins else 0]]
