"""The bf16 training route's stages, each run alone from given inputs.

A whole bf16 step cannot be held to another implementation's step with
any power: once two bf16 computations part on one element (two orders
of a float32 sum that round to different bf16 values), every later
rounding parts too, and within a few layers they differ by as much as
either differs from float32.  Run alone from the same bf16 inputs with
the same output gradient, a stage parts from another implementation
only by its own roundings, while a float32 run of the stage on the same
values parts by every bf16 rounding of the stage: a bar between the two
has power.

Each stage runs the route's own cast (``engine.train.on_copies``): the
stage's float32 parameters and buffers as bf16 copies through
``functional_call``, its gradients reaching the float32 parameters.
``STAGES`` names, per stage, a module of ``AOCNet`` and the inputs it
takes; ``"matching"`` is ``segment_frame(train=True)`` up to the
matching maps it hands the pre-head (global, cluster, proxy and local
matching on bf16 embeddings), differentiated in the three embeddings.

``stage_vjp`` runs one stage; ``stage_gaps`` compares a device's run of
every stage with the CPU's (``chip_smoke.py`` phase 6b, the card tests)
beside the control: the same device running the stage in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import Config
from ..models import DecoderMemory
from ..ops import prng
from .train import bank_rows, on_copies

# name → (module path in AOCNet, inputs as (shape NHWC, kind)); kinds:
# "act" |N(0, 1)| (a ReLU's output), "any" N(0, 1).  The shapes are the
# stages' widths in the resnet101_aocnet preset at small grids.
STAGES = {
    "layer1_0": ("feature_extracter.backbone.layer1.0",
                 [((2, 17, 17, 64), "act")]),
    "layer2_0": ("feature_extracter.backbone.layer2.0",
                 [((2, 17, 17, 256), "act")]),
    "layer3_5": ("feature_extracter.backbone.layer3.5",
                 [((2, 9, 9, 1024), "act")]),
    "layer4_0": ("feature_extracter.backbone.layer4.0",
                 [((2, 9, 9, 1024), "act")]),
    "aspp": ("feature_extracter.aspp", [((2, 5, 5, 2048), "act")]),
    "decoder": ("feature_extracter.decoder",
                [((2, 5, 5, 256), "act"), ((2, 17, 17, 256), "act")]),
    "semantic_embedding": ("semantic_embedding",
                           [((2, 17, 17, 256), "act")]),
    "prehead": ("dynamic_prehead", [((3, 17, 17, None), "any")]),
    "seg_IA1": ("dynamic_seghead.IA1",
                [((3, 17, 17, None), "act"), ((3, None), "any")]),
    "seg_layer1": ("dynamic_seghead.layer1", [((3, 17, 17, None), "act")]),
    "seg_aspp": ("dynamic_seghead.ASPP", [((3, 9, 9, 512), "act")]),
    "matching": ("", []),
}
# matching stage: embedding grid, objects
MATCH_HW, MATCH_O = (17, 17), 3
# card against CPU, each stage's bars on (output, input gradients,
# parameter gradients), relative L2: the geometric mean of the largest
# bf16 gap and the smallest gap of the card's float32 control over
# seeds 0–2 (an H100, TF32 off), where the control is at least 4 times
# farther; each bar must stay below the control's gap (``stage_gaps``
# asserts it).  None: no power there.  A stage with a group norm has
# none even card against CPU: the CPU's bf16 group norm rounds the
# float32 result once, the card's parts from that by bf16 noise
# (semantic_embedding 4.7–5.2e-3 against the control's 4.5e-3).
CARD_BARS: Dict[str, Tuple[Optional[float], ...]] = {
    "layer1_0": (5.5e-4, 3.1e-3, 3.2e-3),
    "layer2_0": (9.2e-4, 1.1e-2, 1.3e-2),
    "layer3_5": (1.1e-3, 1.3e-2, 2.4e-2),
    "layer4_0": (1.3e-3, 1.8e-2, 1.9e-2),
    "aspp": (1.2e-3, 2.2e-3, 2.3e-3),
    "decoder": (1.5e-3, 2.2e-2, 2.1e-2),
    "semantic_embedding": (None, None, None),
    "prehead": (None, None, None),
    "seg_IA1": (8.3e-5, None, None),
    "seg_layer1": (None, None, None),
    "seg_aspp": (None, None, None),
    "matching": (2.7e-3, 3.6e-3, 1.0e-3),
}


def _shapes(cfg: Config, name: str):
    """``STAGES[name]``'s input shapes with the config's widths filled in."""
    widths = {"prehead": cfg.prehead_in_dim,
              "seg_IA1": (cfg.MODEL_SEMANTIC_EMBEDDING_DIM
                          + cfg.MODEL_PRE_HEAD_EMBEDDING_DIM,
                          cfg.attention_head_dim),
              "seg_layer1": (cfg.MODEL_SEMANTIC_EMBEDDING_DIM
                             + cfg.MODEL_PRE_HEAD_EMBEDDING_DIM)}
    out = []
    for i, (shape, kind) in enumerate(STAGES[name][1]):
        if None in shape:
            w = widths[name]
            w = w[i] if isinstance(w, tuple) else w
            shape = tuple(w if s is None else s for s in shape)
        out.append((shape, kind))
    return out


def bf16_values(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to the nearest bf16 (ties to even), as
    float32: inputs both sides can hold exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def matching_inputs(cfg: Config, seed: int) -> Dict[str, np.ndarray]:
    """The matching stage's inputs: embeddings (bf16 values) of the
    current, reference and previous frames (one field, N(0, 0.05²) noise
    each), the low-level feature, label
    maps of ``MATCH_O - 1`` objects, object flags and k-means scores of
    ``prng.prng_key(seed)`` (split per object, as the JAX trainer
    splits its frame key)."""
    rng = np.random.default_rng(seed)
    h, w = MATCH_HW
    c = cfg.MODEL_SEMANTIC_EMBEDDING_DIM
    low_c = 24 if cfg.MODEL_BACKBONE == "mobilenet" else \
        cfg.MODEL_LOW_LEVEL_INPLANES
    # one field seen three times with a little noise: the nearest
    # distances are O(1), where the squashed maps have gradients
    base = np.abs(rng.standard_normal((h, w, c)))
    emb = {k: bf16_values((base + 0.05 * rng.standard_normal((h, w, c)))
                          .astype(np.float32)) for k in ("cur", "ref", "prev")}
    lab = np.zeros((h, w), np.int64)
    lab[2:9, 1:8] = 1
    lab[10:16, 8:16] = 2
    prev_lab = np.roll(lab, (1, 1), (0, 1))
    o = MATCH_O
    keys = prng.split(prng.prng_key(seed), o)
    scores = prng.uniform(keys, bank_rows(cfg, (h, w)), 0.5, 1.0)
    return dict(emb, low=bf16_values(np.abs(rng.standard_normal(
                    (h, w, low_c))).astype(np.float32)),
                ref_onehot=np.eye(o, dtype=np.float32)[lab],
                prev_onehot=np.eye(o, dtype=np.float32)[prev_lab],
                obj_valid=np.ones(o, np.float32), scores=scores.numpy())


def stage_inputs(cfg: Config, name: str, seed: int
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Inputs (bf16 values, float32 arrays, NHWC) and an output gradient
    of stage ``name``, from ``seed``."""
    if name == "matching":
        m = matching_inputs(cfg, seed)
        h, w = MATCH_HW
        n_ch = cfg.prehead_in_dim
        cot = output_gradient((MATCH_O, h, w, n_ch), seed)
        return [m["cur"], m["ref"], m["prev"]], cot
    rng = np.random.default_rng(seed)
    xs = []
    for shape, kind in _shapes(cfg, name):
        a = rng.standard_normal(shape).astype(np.float32)
        xs.append(bf16_values(np.abs(a) if kind == "act" else a))
    return xs, None


def output_gradient(shape, seed: int) -> np.ndarray:
    """A stage's output gradient when ``stage_inputs`` gives none:
    N(0, 1) of the output's shape from ``seed`` + 1."""
    return np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)


def _nchw(t):
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def stage_vjp(model, name: str, xs: Sequence[np.ndarray],
              cot, dtype: torch.dtype, seed: int = 0):
    """Stage ``name`` of ``model`` on its device, in ``dtype`` through the
    route's cast, from inputs ``xs`` with output gradient ``cot`` (None:
    N(0, 1) drawn from ``seed`` + 1) → (output NHWC, input gradients,
    parameter gradients by name), float32 numpy on the host."""
    dev = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    leaves = [torch.from_numpy(x).to(dev, dtype).requires_grad_()
              for x in xs]
    net = on_copies(model, dtype)
    if name == "matching":
        out = _matching_maps(model, net, leaves, dtype, seed)
    else:
        path = STAGES[name][0]
        args = [_nchw(t) for t in leaves]
        if name == "aspp":
            args.append(None)                       # no dropout
        out = _nhwc(net(f"{path}.forward", *args))
    if cot is None:
        cot = output_gradient(tuple(out.shape), seed)
    out.backward(torch.from_numpy(cot).to(dev, out.dtype))
    grads = {n: p.grad.float().cpu().numpy()
             for n, p in model.named_parameters() if p.grad is not None}
    return (out.detach().float().cpu().numpy(),
            [t.grad.float().cpu().numpy() for t in leaves], grads)


def _matching_maps(model, net, leaves, dtype, seed):
    """``segment_frame(train=True)``'s matching maps [O, h, w, n] (the
    pre-head's input, taken by a hook) from the bf16 embeddings."""
    cfg = model.cfg
    dev = leaves[0].device
    m = matching_inputs(cfg, seed)
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in m.items()}
    h, w = MATCH_HW
    mem = DecoderMemory.empty(MATCH_O, (h + 1) // 2, (w + 1) // 2,
                              cfg.MODEL_HEAD_EMBEDDING_DIM, dtype, dev)
    seen = []
    hook = model.dynamic_prehead.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
    try:
        cur, ref, prev = leaves
        net("segment_frame", cur, t["low"].to(dtype), ref[None],
            t["ref_onehot"][None].to(dtype), torch.ones(1, device=dev),
            prev, t["prev_onehot"].to(dtype), t["obj_valid"], mem,
            t["scores"], train=True)
    finally:
        hook.remove()
    return seen[0].permute(0, 2, 3, 1)


def rel_l2(got, want) -> float:
    """‖got − want‖ / ‖want‖ over arrays (or lists / dicts of them, all
    together)."""
    if isinstance(want, dict):
        got, want = [got[k] for k in want], list(want.values())
    if isinstance(want, (list, tuple)):
        num = sum(float(np.square(g - w).sum()) for g, w in zip(got, want))
        den = sum(float(np.square(w).sum()) for w in want)
    else:
        num = float(np.square(got - want).sum())
        den = float(np.square(want).sum())
    return (num / den) ** 0.5 if den else float(num > 0)


def gaps(got, want) -> Tuple[float, float, float]:
    """(output, input gradients, parameter gradients) relative L2 of two
    ``stage_vjp`` results."""
    return (rel_l2(got[0], want[0]), rel_l2(got[1], want[1]),
            rel_l2(got[2], want[2]))


def stage_gaps(cpu_model, dev_model, names=None, seed: int = 0) -> Dict:
    """Per stage, the device's bf16 run against the CPU's and the
    control (the device's float32 run against the CPU's bf16 run), each
    (output, input gradients, parameter gradients); ``failures`` lists
    the stages past a bar of ``CARD_BARS`` or where the control is not
    past it (power)."""
    out, failures = {}, []
    for name in names or STAGES:
        xs, cot = stage_inputs(cpu_model.cfg, name, seed)
        ref = stage_vjp(cpu_model, name, xs, cot, torch.bfloat16, seed)
        got = stage_vjp(dev_model, name, xs, cot, torch.bfloat16, seed)
        ctl = stage_vjp(dev_model, name, xs, cot, torch.float32, seed)
        g, c = gaps(got, ref), gaps(ctl, ref)
        out[name] = {"bf16": g, "float32": c}
        if any(b is not None and not v <= b < w
               for v, b, w in zip(g, CARD_BARS[name], c)):
            failures.append(name)
    return {"stages": out, "failures": failures}
