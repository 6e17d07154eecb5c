"""Frame transforms (the port's own copy of
``rvos_tpu/data/transforms.py``).

Eval: ``restrict_size`` caps the long edge, applies the multi-scale
factor and snaps H, W to the (x−1)%16==0 grid the stride tower expects;
``eval_variants`` builds the per-scale variants.

Train: ``random_scale`` (short-edge align × [min, max]) →
``balanced_random_crop`` (keeps objects of the reference crop, at most
``max_obj_num``, relabelled contiguously) → ``random_hflip`` →
``normalize`` (or the train step normalises uint8 frames on the
device).  Each draws from the ``np.random.Generator`` it is given, in
the JAX package's order, so one seed gives the JAX package's samples.

cv2 or PIL is imported only when a frame is resized (cv2 when
installed, as the JAX package chooses)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _resize_img(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bicubic frame resize (cv2 when installed, else PIL)."""
    if img.shape[:2] == tuple(hw):
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, dsize=(hw[1], hw[0]),
                          interpolation=cv2.INTER_CUBIC)
    from PIL import Image
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (hw[1], hw[0]), Image.BICUBIC)).astype(img.dtype)


def _resize_label(lab: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest label resize (cv2 when installed, else PIL)."""
    if lab.shape[:2] == tuple(hw):
        return lab
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(lab, dsize=(hw[1], hw[0]),
                          interpolation=cv2.INTER_NEAREST)
    from PIL import Image
    return np.asarray(Image.fromarray(lab).resize((hw[1], hw[0]),
                                                  Image.NEAREST))


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8/float [H, W, 3] RGB → float32 ImageNet-normalised."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _map_sample(sample: Dict, img_fn, label_fn) -> Dict:
    """Apply ``img_fn``/``label_fn`` to every frame of a train sample
    (lists of frames included); ``meta`` passes through."""
    out = {}
    for k, v in sample.items():
        if k == "meta":
            out[k] = v
            continue
        fn = label_fn if "label" in k else img_fn
        out[k] = [fn(x) for x in v] if isinstance(v, list) else fn(v)
    return out


def random_scale(sample: Dict, short_edge: int, min_f: float, max_f: float,
                 rng: np.random.Generator) -> Dict:
    """Short-edge align, then a random scale in [min_f, max_f]."""
    h, w = sample["ref_img"].shape[:2]
    sc = short_edge / min(h, w)
    sc *= rng.uniform(min_f, max_f)
    hw = (int(round(h * sc)), int(round(w * sc)))
    return _map_sample(sample, lambda x: _resize_img(x, hw),
                       lambda x: _resize_label(x, hw))


def balanced_random_crop(sample: Dict, size: Tuple[int, int],
                         rng: np.random.Generator, max_step: int = 5,
                         max_obj_num: int = 5,
                         min_obj_pixel_num: int = 100) -> Dict:
    """Object-preserving random crop with contiguous relabelling: up to
    ``max_step`` crops are drawn until the reference frame's crop keeps
    an object of more than ``min_obj_pixel_num`` pixels; more than
    ``max_obj_num`` such objects are cut to a random subset; every frame
    is relabelled to that set (other objects become background)."""
    ref_label = sample["ref_label"]
    h, w = ref_label.shape[:2]
    nh, nw = min(size[0], h), min(size[1], w)

    top, left, objs = 0, 0, []
    for _ in range(max_step):
        top = int(rng.integers(0, h - nh + 1))
        left = int(rng.integers(0, w - nw + 1))
        ref_crop = ref_label[top:top + nh, left:left + nw]
        objs = np.unique(ref_crop)
        objs = objs[objs != 0]
        objs = [o for o in objs
                if (ref_crop == o).sum() > min_obj_pixel_num]
        if objs:
            if len(objs) > max_obj_num:
                objs = list(rng.permutation(np.asarray(objs))[:max_obj_num])
            break

    remap = np.zeros(256, np.uint8)
    for new_id, old_id in enumerate(objs, start=1):
        remap[old_id] = new_id
    out = _map_sample(sample, lambda x: x[top:top + nh, left:left + nw],
                      lambda x: remap[x[top:top + nh, left:left + nw]])
    out["meta"] = dict(sample.get("meta", {}), obj_num=len(objs))
    return out


def random_hflip(sample: Dict, p: float, rng: np.random.Generator) -> Dict:
    """Mirror every frame with probability ``p``."""
    if rng.uniform() >= p:
        return sample
    flip = lambda x: np.ascontiguousarray(x[:, ::-1])  # noqa: E731
    return _map_sample(sample, flip, flip)


def snap_16(x: int) -> int:
    """(x-1) % 16 == 0 snap."""
    if (x - 1) % 16 != 0:
        x = int(np.around((x - 1) / 16.0) * 16 + 1)
    return x


def restrict_size(h: int, w: int, max_size: Optional[float] = 800 * 1.3,
                  min_size: Optional[int] = None,
                  scale: float = 1.0) -> Tuple[int, int]:
    """Eval resize policy (reference MultiRestrictSize)."""
    sc = None
    if min_size is not None:
        short = min(h, w)
        if short > min_size:
            sc = float(min_size) / short
    else:
        long = max(h, w)
        if max_size is not None and long > max_size:
            sc = float(max_size) / long
    nh, nw = (h, w) if sc is None else (sc * h, sc * w)
    return snap_16(int(nh * scale)), snap_16(int(nw * scale))


def variant_list(flip: bool, multi_scale: Sequence[float]
                 ) -> List[Tuple[float, bool]]:
    """(scale, flip) of each eval variant, in ``eval_variants``' order."""
    return [(s, f) for s in multi_scale
            for f in ((False, True) if flip else (False,))]


def eval_variants(img: np.ndarray, max_size: Optional[float],
                  min_size: Optional[int], flip: bool,
                  multi_scale: Sequence[float]) -> List[Dict]:
    """One resized variant per scale (+ a flip twin per scale when
    ``flip``; flip twins carry the unflipped pixels)."""
    h, w = img.shape[:2]
    sized = {}
    variants = []
    for scale, f in variant_list(flip, multi_scale):
        if scale not in sized:
            nh, nw = restrict_size(h, w, max_size, min_size, scale)
            sized[scale] = (_resize_img(img, (nh, nw))
                            if (nh, nw) != (h, w) else img)
        variants.append({"img": sized[scale], "flip": f, "scale": scale})
    return variants


def frame_u8(img: np.ndarray) -> np.ndarray:
    """uint8 frame for upload: round-to-nearest of float frames."""
    if img.dtype == np.uint8:
        return img
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)
