"""DAVIS J&F metrics, region similarity J and boundary F-measure (the
port's own copy of ``rvos_tpu/utils/davis_metrics.py``).

The DAVIS toolkit's semantics (``davis-2017`` ``f_boundary.py``): J is
the IoU of the binary masks; F is the contour F-measure of
``seg2bmap`` boundary maps matched within a Euclidean disk of radius
``ceil(0.008 · image diagonal)`` (binary dilation with the exact
``x² + y² ≤ r²`` footprint, as ``skimage.morphology.disk``), with the
toolkit's conventions for empty contours.  numpy only: the dilation is
the OR of the mask shifted over the footprint's offsets (what
``cv2.dilate`` computes, zero outside the image); PIL is imported only
to read PNGs.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    union = np.count_nonzero(pred | gt)
    if union == 0:
        return 1.0
    return np.count_nonzero(pred & gt) / union


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Boundary map of a binary segmentation — the DAVIS toolkit's
    ``seg2bmap`` (BSDS lineage): a pixel is boundary iff it differs
    from its east, south, or south-east neighbour, with the last
    row/column compared against their in-image neighbour only and the
    bottom-right corner forced off."""
    s = seg.astype(bool)
    e = np.zeros_like(s)
    so = np.zeros_like(s)
    se = np.zeros_like(s)
    e[:, :-1] = s[:, 1:]
    so[:-1, :] = s[1:, :]
    se[:-1, :-1] = s[1:, 1:]
    b = (s ^ e) | (s ^ so) | (s ^ se)
    b[-1, :] = s[-1, :] ^ e[-1, :]
    b[:, -1] = s[:, -1] ^ so[:, -1]
    b[-1, -1] = False
    return b.astype(np.uint8)


def _disk(radius: float) -> np.ndarray:
    """Exact Euclidean-disk footprint (``x²+y² ≤ r²``), identical to
    ``skimage.morphology.disk`` as used by the toolkit."""
    r = int(radius)
    ax = np.arange(-r, r + 1)
    x, y = np.meshgrid(ax, ax)
    return ((x * x + y * y) <= radius * radius).astype(np.uint8)


def _dilate(mask: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Binary dilation: OR of ``mask`` shifted over the footprint's
    offsets, zero outside the image."""
    if footprint.shape[0] <= 1:
        return mask
    r = footprint.shape[0] // 2
    pad = np.pad(mask, r)
    out = np.zeros_like(mask)
    h, w = mask.shape
    for dy, dx in zip(*np.nonzero(footprint)):
        out |= pad[dy:dy + h, dx:dx + w]
    return out


def f_measure(pred: np.ndarray, gt: np.ndarray,
              bound_th: float = 0.008) -> float:
    """Toolkit-exact boundary F (``davis-2017`` ``db_eval_boundary``):
    seg2bmap contours, disk(ceil(bound_th·‖shape‖₂)) dilation, and the
    toolkit's empty-contour conventions (empty-vs-empty → P=R=1;
    one-sided empty → the empty side scores 1, the other 0 → F=0)."""
    bound_pix = (bound_th if bound_th >= 1
                 else np.ceil(bound_th * np.linalg.norm(pred.shape)))
    pred_b = seg2bmap(pred)
    gt_b = seg2bmap(gt)
    fp = _disk(bound_pix)
    pred_dil = _dilate(pred_b, fp)
    gt_dil = _dilate(gt_b, fp)
    n_pred = pred_b.sum()
    n_gt = gt_b.sum()
    if n_pred == 0 and n_gt == 0:
        precision = recall = 1.0
    elif n_pred == 0:
        precision, recall = 1.0, 0.0
    elif n_gt == 0:
        precision, recall = 0.0, 1.0
    else:
        precision = ((pred_b & (gt_dil > 0)).sum()) / float(n_pred)
        recall = ((gt_b & (pred_dil > 0)).sum()) / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def evaluate_sequence(pred_masks: Sequence[np.ndarray],
                      gt_masks: Sequence[np.ndarray],
                      object_ids: Sequence[int]) -> Dict[int, Dict[str, float]]:
    """Per-object mean J and F over a sequence (first/last frames
    excluded per DAVIS convention when seq length > 2)."""
    n = len(pred_masks)
    idxs = range(1, n - 1) if n > 2 else range(n)
    out = {}
    for oid in object_ids:
        js, fs = [], []
        for i in idxs:
            p = pred_masks[i] == oid
            g = gt_masks[i] == oid
            js.append(jaccard(p, g))
            fs.append(f_measure(p, g))
        out[oid] = {"J": float(np.mean(js)), "F": float(np.mean(fs))}
    return out


def mean_jf(per_object: Dict[int, Dict[str, float]]) -> Dict[str, float]:
    js = [v["J"] for v in per_object.values()]
    fs = [v["F"] for v in per_object.values()]
    j = float(np.mean(js)) if js else 0.0
    f = float(np.mean(fs)) if fs else 0.0
    return {"J": j, "F": f, "J&F": (j + f) / 2}


def evaluate_dataset_jf(result_root: str, label_root: str,
                        seqs: Sequence[str] | None = None) -> Dict:
    """End-to-end J&F over saved result PNGs vs GT annotations.

    ``result_root/<seq>/<frame>.png`` is compared against
    ``label_root/<seq>/<frame>.png`` for every frame with GT (the
    external DAVIS-toolkit workflow the reference relies on,
    ``README.md:110``, made self-contained).  Per-object scores are
    averaged DAVIS-style: objects pooled across sequences.
    """
    from PIL import Image

    if seqs is None:
        seqs = sorted(
            s for s in os.listdir(result_root)
            if os.path.isdir(os.path.join(result_root, s)))
    per_seq: Dict[str, Dict[str, float]] = {}
    all_j, all_f = [], []
    for seq in seqs:
        rdir = os.path.join(result_root, seq)
        gdir = os.path.join(label_root, seq)
        if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
            continue
        preds, gts = [], []
        for fname in sorted(os.listdir(rdir)):
            gpath = os.path.join(gdir, fname)
            if not fname.endswith(".png") or not os.path.exists(gpath):
                continue
            preds.append(np.array(Image.open(os.path.join(rdir, fname))))
            gts.append(np.array(Image.open(gpath)))
        if not preds:
            continue
        ids = sorted({int(i) for g in gts for i in np.unique(g)} - {0, 255})
        per_object = evaluate_sequence(preds, gts, ids)
        per_seq[seq] = mean_jf(per_object)
        all_j.extend(v["J"] for v in per_object.values())
        all_f.extend(v["F"] for v in per_object.values())
    j = float(np.mean(all_j)) if all_j else 0.0
    f = float(np.mean(all_f)) if all_f else 0.0
    return {"per_seq": per_seq, "J": j, "F": f, "J&F": (j + f) / 2}
