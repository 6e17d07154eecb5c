"""The model's FLOPs per frame, counted by the benchmark.

A video with n objects has n + 1 live object channels (the background
and its objects); the port pads them to ``MODEL_MAX_OBJ_NUM``, and the
padded channels are not counted.  The dense layers (the feature
extractor, the pre-head and the decoder over the live channels) are
counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference
run on meta tensors (shapes only, nothing computed); the matching
streams by formula from the same shapes (a multiply-add is 2 FLOPs):
global matching 2·M·P·C, k-means (iters + 1 assignments and updates over
P rows for each of the O live channels) 4·(iters + 1)·O·P·K·C, cluster
matching 2·M·2·O·K·C, proxy matching 2·M·O·C, local matching
2·S·C·pairs for both previous embeddings.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from ..reference.aocnet import Ref
from .kernels import window_pairs


def _meta_state(shapes: Dict[str, torch.Size]) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(tuple(s), device="meta") for n, s in shapes.items()}


def dense_flops(shapes: Dict[str, torch.Size], cfg: Dict, backbone: str,
                hw, channels: Optional[int] = None) -> Dict[str, float]:
    """{"extract": one frame's feature extraction, "decode": one frame's
    pre-head and decoder over ``channels`` object channels (default
    ``MODEL_MAX_OBJ_NUM``)} at input size ``hw`` (the eval-resized
    frame)."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = Ref(_meta_state(shapes), backbone)
    x = torch.empty((1, 3, hw[0], hw[1]), device="meta")
    with FlopCounterMode(display=False) as fc:
        emb, low = ref.extract_feature(x)
    extract = fc.get_total_flops()
    o = channels or cfg["MODEL_MAX_OBJ_NUM"]
    c, h, w = emb.shape[1:]
    n_maps = shapes["dynamic_prehead.conv.weight"][1]
    maps = torch.empty((o, n_maps, h, w), device="meta")
    head = torch.empty((o, 4 * c), device="meta")
    ov = torch.ones(o, device="meta")
    with FlopCounterMode(display=False) as fc:
        pre = ref.conv("dynamic_prehead.conv", maps)
        xin = torch.cat([emb.expand(o, -1, -1, -1), pre], dim=1)
        ref.decode(xin, head, low, ov, cfg["MODEL_BETA_PERCENTAGE"], None)
    return {"extract": float(extract), "decode": float(fc.get_total_flops()),
            "grid": (int(h), int(w)), "channels": int(c)}


def matching_flops(cfg: Dict, grid, c: int, bank_rows: int,
                   channels: Optional[int] = None) -> float:
    """One frame's matching streams by formula (see the module) over
    ``channels`` object channels (default ``MODEL_MAX_OBJ_NUM``)."""
    h, w = grid
    m = h * w
    o = channels or cfg["MODEL_MAX_OBJ_NUM"]
    k = cfg["MODEL_CLUSTER_NUM"]
    iters = cfg["MODEL_KMEANS_ITERS"]
    radii = cfg["MODEL_MULTI_LOCAL_DISTANCE"]
    lh, lw = h // 2 + 1, w // 2 + 1
    return (2.0 * m * bank_rows * c
            + 4.0 * (iters + 1) * o * bank_rows * k * c
            + 2.0 * m * 2 * o * k * c
            + 2.0 * m * o * c
            + 2.0 * 2 * c * window_pairs(lh, lw, int(radii[-1])))


def eval_frame_flops(shapes, cfg: Dict, backbone: str, hw,
                     channels: Iterable[int]) -> Dict:
    """{"frame0": a video's first frame (extraction alone), "frame": {n:
    every later frame of a video with n live channels} for each n of
    ``channels``}."""
    frame = {}
    for n in sorted(set(channels)):
        d = dense_flops(shapes, cfg, backbone, hw, n)
        frame[n] = d["extract"] + d["decode"] + matching_flops(
            cfg, d["grid"], d["channels"], cfg["MATCHING_MAX_REF_PIXELS"], n)
    return {"frame0": d["extract"], "frame": frame}
