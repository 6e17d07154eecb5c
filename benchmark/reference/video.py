"""The output check of an eval cell: the reference follows the program's
masks through a video and judges each of them.

Whole videos part between two correct implementations from rounding
alone (a mask feeds the bank and the next frame), so the reference does
not segment a video on its own.  It follows the program's own answers,
as a served language model's tokens are scored under a reference: at
each frame it takes the program's mask of the frame before as the
previous mask, and builds its bank from the program's masks with its
own uncertainty gate; everything else (the eval resize, the features,
the five matching streams, the k-means draws and clustering, the bank
compaction, the decoder and its memory, the probabilities) it works out
itself.  Then each pixel of the program's mask is scored by the gap
between the reference's best probability there and its probability of
the program's label: 0 where the program picked the reference's best.
Pixels that a join frame's given mask sets are not scored.

The control (``control_cast``) runs a second copy of the reference with
every product's operands in a lower precision, along the same masks,
and scores the label it puts first in the same way.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .aocnet import Ref, nearest, one_hot, plain_precision
from .bank import UNCERTAIN, compact_occupancy, entropy
from .prng import kmeans_scores

THRESHOLDS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def snap_16(x: int) -> int:
    """The nearest size of the form 16·n + 1."""
    if (x - 1) % 16 != 0:
        x = int(np.around((x - 1) / 16.0) * 16 + 1)
    return x


def eval_size(h: int, w: int, max_size: float):
    """The eval resize's size: the long edge capped at ``max_size``, then
    both edges snapped to 16·n + 1."""
    long = max(h, w)
    sc = float(max_size) / long if long > max_size else None
    nh, nw = (h, w) if sc is None else (sc * h, sc * w)
    return snap_16(int(nh)), snap_16(int(nw))


def _cubic_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """[out, in] bicubic weights (A = -0.75), pixel centres aligned, the
    edge pixels repeated past the border."""
    a = -0.75
    scale = in_size / out_size
    x = (torch.arange(out_size, dtype=torch.float64) + 0.5) * scale - 0.5
    x0 = torch.floor(x)
    t = x - x0
    w = torch.stack([
        ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
        ((a + 2) * t - (a + 3)) * t * t + 1,
        ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1], dim=1)
    w = torch.cat([w, 1 - w.sum(1, keepdim=True)], dim=1)
    m = torch.zeros((out_size, in_size), dtype=torch.float64)
    for k in range(4):
        idx = (x0 + k - 1).clamp(0, in_size - 1).long()
        m.index_put_((torch.arange(out_size), idx), w[:, k], accumulate=True)
    return m.to(device)


def resize_frames(frames: torch.Tensor, hw) -> torch.Tensor:
    """uint8 [T, H, W, 3] → uint8 [T, h, w, 3], bicubic, rounded."""
    t, h, w, _ = frames.shape
    if (h, w) == tuple(hw):
        return frames
    my = _cubic_matrix(hw[0], h, frames.device)
    mx = _cubic_matrix(hw[1], w, frames.device)
    out = []
    for f in frames:
        x = f.double().permute(2, 0, 1)
        y = torch.matmul(torch.matmul(my, x), mx.t())
        out.append(y.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0))
    return torch.stack(out)


def normalise(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [T, H, W, 3] → ImageNet-normalised float32 [T, 3, H, W]."""
    dev = frames_u8.device
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    return ((frames_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


class Scores:
    """Gap statistics over the scored pixels."""

    def __init__(self):
        self.pixels = 0
        self.frames = 0
        self.gap_max = 0.0
        self.differ = 0
        self.over = {t: 0 for t in THRESHOLDS}

    def add(self, gap: torch.Tensor, differ: torch.Tensor):
        self.pixels += gap.numel()
        self.frames += 1
        if gap.numel():
            self.gap_max = max(self.gap_max, float(gap.max()))
        self.differ += int(differ.sum())
        for t in THRESHOLDS:
            self.over[t] += int((gap > t).sum())

    def summary(self) -> Dict:
        n = max(self.pixels, 1)
        return {"frames": self.frames, "pixels": self.pixels,
                "gap_max": self.gap_max, "differ_share": self.differ / n,
                **{f"over_{t}": self.over[t] / n for t in THRESHOLDS}}


class _Track:
    """One network's streaming state along a video."""

    def __init__(self, ref: Ref):
        self.ref = ref
        self.bank_emb: List[torch.Tensor] = []
        self.memory = None
        self.prev_emb = None
        self.flat = None


def _embed(ref: Ref, x: torch.Tensor, batch: int = 4):
    embs, lows = [], []
    for i in range(0, x.shape[0], batch):
        e, low = ref.extract_feature(x[i:i + batch])
        embs.append(e)
        lows.append(low)
    return torch.cat(embs), torch.cat(lows)


@torch.no_grad()
def check_video(sd: Dict[str, torch.Tensor], cfg: Dict, backbone: str,
                frames: np.ndarray, labels: Dict[int, np.ndarray],
                obj_num: int, masks: Dict[int, np.ndarray], device,
                scores: Scores, control_cast: Optional[Callable] = None,
                control: Optional[Scores] = None) -> None:
    """Score the program's ``masks`` {frame: uint8 [H0, W0]} of one video
    (``frames`` uint8 [T, H0, W0, 3], ``labels`` the given masks) into
    ``scores`` (and the control's choices into ``control``)."""
    with plain_precision():
        _check_video(sd, cfg, backbone, frames, labels, obj_num, masks,
                     device, scores, control_cast, control)


def _check_video(sd, cfg, backbone, frames, labels, obj_num, masks, device,
                 scores, control_cast, control):
    o = cfg["MODEL_MAX_OBJ_NUM"]
    cap = cfg["TEST_BANK_CAPACITY"]
    t_len, h0, w0, _ = frames.shape
    hw = eval_size(h0, w0, cfg["TEST_MAX_SIZE"])
    tracks = [_Track(Ref(sd, backbone))]
    if control_cast is not None:
        tracks.append(_Track(Ref(sd, backbone, control_cast)))
    ov = (torch.arange(o, device=device) <= obj_num).float()
    em = torch.zeros(o, device=device)
    bank_lab: List[torch.Tensor] = []
    ring = 1
    chunk = 8
    for lo in range(0, t_len, chunk):
        x = normalise(resize_frames(
            torch.from_numpy(frames[lo:lo + chunk]).to(device), hw))
        feats = [_embed(tr.ref, x) for tr in tracks]
        for j in range(x.shape[0]):
            t = lo + j
            given = labels.get(t)
            join = None
            if given is not None:
                join = torch.from_numpy(given.astype(np.int64)).to(device)
                for lid in torch.unique(join).tolist():
                    if lid != 255 and lid < o:
                        em[lid] = 1.0
            small_hw = feats[0][0].shape[-2:]
            if t == 0:
                lab0 = nearest(join, small_hw)
                bank_lab = [lab0]
                for tr, (emb, _) in zip(tracks, feats):
                    tr.bank_emb = [emb[j]]
                    tr.prev_emb = emb[j]
                prev_lab = lab0
                continue
            probs = []
            for tr, (emb, low) in zip(tracks, feats):
                if tr.flat is None:
                    s = len(tr.bank_emb)
                    be = torch.stack(tr.bank_emb)
                    c = be.shape[1]
                    flat_e = be.permute(0, 2, 3, 1).reshape(-1, c)
                    flat_l = (one_hot(torch.stack(bank_lab), o) * ov).reshape(
                        -1, o)
                    pad = cap - s                 # empty slots of the ring
                    if pad:
                        flat_e = torch.cat([flat_e, flat_e.new_zeros(
                            (pad * small_hw[0] * small_hw[1], c))])
                        flat_l = torch.cat([flat_l, flat_l.new_zeros(
                            (pad * small_hw[0] * small_hw[1], o))])
                    tr.flat = compact_occupancy(
                        flat_e, flat_l, cfg["MATCHING_MAX_REF_PIXELS"])
                fe, fl = tr.flat
                logits, tr.memory = tr.ref.segment(
                    cfg, emb[j], low[j:j + 1], torch.stack(tr.bank_emb),
                    torch.stack(bank_lab), torch.ones(len(bank_lab),
                                                      device=device),
                    fe, fl, tr.prev_emb, prev_lab, ov,
                    kmeans_scores(t, o, fe.shape[0], device), tr.memory)
                p = torch.softmax(F.interpolate(
                    logits[None], size=(h0, w0), mode="bilinear",
                    align_corners=True)[0], dim=0)
                probs.append(p * em[:, None, None])
            pm = probs[0]
            prog = torch.from_numpy(masks[t].astype(np.int64)).to(device)
            keep = torch.ones_like(prog, dtype=torch.bool) if join is None \
                else join == 0
            best = pm.max(dim=0).values
            gap = best - pm.gather(0, prog[None])[0]
            scores.add(gap[keep], (prog != pm.argmax(dim=0))[keep])
            if control is not None:
                pick = probs[1].argmax(dim=0)
                cgap = best - pm.gather(0, pick[None])[0]
                control.add(cgap[keep], (pick != pm.argmax(dim=0))[keep])
            # the bank's label: the program's mask, uncertain pixels 125
            conf = torch.where(entropy(probs[0], em) > cfg["UNC_RATIO"],
                               torch.full_like(prog, UNCERTAIN), prog)
            if join is not None:
                conf = torch.where(join == 0, conf, join)
            prev_lab = nearest(prog, small_hw)
            for tr, (emb, _) in zip(tracks, feats):
                tr.prev_emb = emb[j]
            mem_frame = cfg["MEM_EVERY"] > 0 and t % cfg["MEM_EVERY"] == 0
            if join is not None or mem_frame:
                small = nearest(conf, small_hw)
                if len(bank_lab) < cap:
                    bank_lab.append(small)
                    for tr, (emb, _) in zip(tracks, feats):
                        tr.bank_emb.append(emb[j])
                else:
                    bank_lab[ring] = small
                    for tr, (emb, _) in zip(tracks, feats):
                        tr.bank_emb[ring] = emb[j]
                ring = ring + 1 if ring + 1 < cap else 1
                for tr in tracks:
                    tr.flat = None
