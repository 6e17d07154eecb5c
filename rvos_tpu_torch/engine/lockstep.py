"""Lock-step comparison of the streaming evaluator on two devices.

A whole-video comparison of two evaluators compounds float noise: the
masks feed the bank and the next frame, so one pixel that flips between
two devices' rounding can change a later frame a great deal (with random
weights, embedding noise of 3e-5 already does:
``python -m rvos_tpu_torch.cli.noise_sensitivity``).  Here one evaluator
streams the video and every call of its ``segment_frame`` is repeated on
a reference model from copies of the very same inputs — the bank, its
precompacted form, the previous frame, the decoder memory, the k-means
draws — so each frame of the two is computed from one state; so is
every ``extract_feature`` call.  Both sides' masks come from their
logits by the evaluator's own upsampling and argmax.  Every bank
compaction (``precompact_bank``) is repeated on the reference device
from copies of its inputs too, and its rows, labels and tile map must
come out identical.

    res = lockstep_masks(cfg, make_model, seq, scores)
    res.agree, res.max_dlogit, res.max_demb, res.banks_equal
    res.unexplained, res.masks_parted
    gate_failures(res)      # [] when the card checks' gate holds

runs the evaluator on CUDA (the kernels) against a CPU reference (their
plain versions).  ``whole_video_agreement`` is the plain comparison of
two independent runs; it also covers the state updates between frames,
but holds only while no flipped pixel reaches the bank.
``parity_config(layout)`` and ``parity_scores`` are the small
parity-mode setting both checks run in.

``lockstep_chunks`` holds the chunked evaluator the same way: every
step (``Evaluator.run_chunk``: a CUDA graph replay for a full chunk on
the card) is repeated eagerly by ``chunk_step`` of a reference evaluator
from copies of the same states and inputs.  With ``ref_device="cuda"``
it compares a graph replay with an eager run of the same function on
the card.  Under the multi-scale/flip ensemble every variant's
``segment_frame`` call is one entry of ``lockstep_masks``, and a chunk's
frames are held by their ensemble masks.

Both harnesses count the entries where the decoder's top-β masks part
(``_MaskWatch``): each mask is a threshold that rounding can move a
pixel across.  With ``share_masks=True`` (the ensemble's checks, where
four to six variants' calls give such a tie a chance on every frame)
the reference goes on with the evaluator's masks, as it takes the
evaluator's bank compactions, and every parted entry must be a near
tie; otherwise it keeps its own, and a parting shows in its logits.

The gate (``gate_failures``): masks agree on ≥ 99.9 % of every frame,
max |Δlogit| < 1e-2, and every pixel where the two sides part is a near
tie: the reference's top-two margin there lies below the frame's max
|Δ| of the scores that decide it (``margin_gate``; the upsampled
logits, or the ensemble's mean probabilities).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch

from ..configs import BANK_LAYOUTS, Config, tiny_test
from ..models import AOCNet, DecoderMemory
from ..models.layers import ConditioningLayer
from ..ops.resize import resize_nchw
from . import eval as eval_mod
from .eval import Evaluator, ScoreFn


MIN_AGREE = 0.999          # the gate: share of every frame's pixels ...
MAX_DLOGIT = 1e-2          # ... and the bound on max |Δlogit|


class LockstepResult(NamedTuple):
    agree: List[float]         # per frame: share of pixels whose masks agree
    max_dlogit: float          # max |Δlogits| over the frames
    max_demb: float            # max |Δ| of the embeddings
    banks_equal: List[bool]    # per bank compaction: identical on both sides
    unexplained: int = 0       # parted pixels and masks that are no near tie
    masks_parted: int = 0      # decoder top-β mask entries that parted


def margin_gate(got: torch.Tensor, want: torch.Tensor,
                parted: torch.Tensor = None) -> Tuple[float, int, int]:
    """One decision's scores on both sides, [O, H, W] on one device
    (``want`` the reference's; objects scored ≤ -1e8 there are invalid
    and left out) → (max |Δ| over the valid scores, the pixels where the
    two sides part — their argmaxes, unless ``parted`` [H, W] says —, and
    those of them whose reference top-two margin is not below that max:
    a parting that rounding alone does not explain)."""
    valid = want > -1e8
    d = torch.where(valid, (got - want).abs(),
                    torch.zeros((), device=got.device))
    dmax = d.max()
    top2 = want.topk(2, dim=0).values
    if parted is None:
        parted = got.argmax(0) != want.argmax(0)
    unexplained = parted & (top2[0] - top2[1] >= dmax)
    return dmax.item(), int(parted.sum()), int(unexplained.sum())


def gate_failures(res) -> List[str]:
    """What a lock-step result (``lockstep_masks``/``lockstep_chunks``)
    fails of the card checks' gate; empty when it holds."""
    out = []
    if not res.agree or min(res.agree) < MIN_AGREE:
        out.append(f"agreement {res.agree} below {MIN_AGREE}")
    if not res.max_dlogit < MAX_DLOGIT:
        out.append(f"max |dlogit| {res.max_dlogit:.3e} not below {MAX_DLOGIT}")
    if res.unexplained:
        out.append(f"{res.unexplained} parted pixels or top-beta mask "
                   f"entries are no near tie")
    return out


# layouts whose whole-video card and CPU runs of the parity setting agree
# (on an H100); at no cap a pixel flipped by rounding at frame 4 enters
# the bank and frame 5 agrees on 94 % only, so it is held frame by frame
WHOLE_VIDEO_LAYOUTS = ("occupancy", "uniform", "unsegmented")


def parity_config(layout: str, matching: str = "float32") -> Config:
    """``tiny_test`` at 65×65 with 4 object channels, 3 bank slots and
    float32 compute, under bank layout ``layout`` (``BANK_LAYOUTS``),
    frame by frame (``TEST_FRAME_CHUNK=1``); the fg-union layout gets a
    cap below the 867 rows of 3 slots, so that its compaction drops rows.
    ``matching="mixed"`` puts the global stream's cross term on bf16
    operands (the kernels' tensor-core path)."""
    cap = dict(MATCHING_MAX_REF_PIXELS=512) if layout == "unsegmented" else {}
    return tiny_test(DATA_RANDOMCROP=(65, 65), MODEL_MULTI_LOCAL_DISTANCE=(2, 4),
                     MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None,
                     TEST_BANK_CAPACITY=3, MEM_EVERY=2, MATCHING_DTYPE=matching,
                     EVAL_COMPUTE_DTYPE="float32", TEST_FRAME_CHUNK=1,
                     **BANK_LAYOUTS[layout], **cap)


def parity_scores(frame_idx: int, n_obj: int, n_rows: int) -> torch.Tensor:
    """k-means init scores drawn on the CPU, the same for every device."""
    g = torch.Generator().manual_seed(frame_idx)
    return 0.5 + 0.5 * torch.rand((n_obj, n_rows), generator=g)


def whole_video_agreement(cfg: Config, make_model: Callable[[], AOCNet],
                          make_seq, kmeans_scores: ScoreFn, device="cuda",
                          ref_device="cpu") -> List[float]:
    """Stream ``make_seq()`` once on each device from ``make_model()`` →
    per frame, the share of pixels whose masks agree."""
    out = []
    for d in (device, ref_device):
        ev = Evaluator(cfg, make_model(), device=d, kmeans_scores=kmeans_scores)
        out.append(ev.evaluate_sequence(make_seq())["results"])
    if sorted(out[0]) != sorted(out[1]):
        raise ValueError(f"frames differ: {sorted(out[0])} / {sorted(out[1])}")
    return [float((out[0][k] == out[1][k]).mean()) for k in sorted(out[1])]


def _to(x, device):
    if isinstance(x, DecoderMemory):
        return DecoderMemory(*(_to(t, device) for t in x))
    return x.to(device) if torch.is_tensor(x) else x


def _identical(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a.to(b.device), b)


def lockstep_masks(cfg: Config, make_model: Callable[[], AOCNet], seq,
                   kmeans_scores: ScoreFn, device="cuda",
                   ref_device="cpu", on_frame=None,
                   share_masks: bool = False,
                   devices=None) -> LockstepResult:
    """Stream ``seq`` with an evaluator on ``device``, repeating each
    frame's ``segment_frame`` and each bank compaction on a reference
    model on ``ref_device``.  ``make_model()`` returns a fresh model with
    the weights both use.  ``on_frame(segment, args, ups)``, when given,
    sees each frame: the evaluator's own ``segment_frame``, the frame's
    arguments and both sides' upsampled logits [O, H, W] on
    ``ref_device`` (``cli.lockstep_flips`` explains the pixels where the
    masks part).  ``share_masks``: see the module's docstring.
    Convolutions run without TF32, which ``device.configure_precision``
    turns off only in parity mode: a comparison with the CPU needs it
    off under mixed matching too.  ``devices``: the evaluator's (its
    context-parallel matching: the reference's ``segment_frame`` runs
    unsplit)."""
    ev = Evaluator(cfg, make_model(), device=device,
                   kmeans_scores=kmeans_scores, devices=devices)
    torch.backends.cudnn.allow_tf32 = False
    ref = make_model().to(device=ref_device, dtype=ev.dtype).eval()
    watch = _MaskWatch(ev.model, ref, share_masks)
    hw = tuple(seq[0]["current_img"].shape[:2])
    segment, extract = ev.model.segment_frame, ev.model.extract_feature
    compact = eval_mod.precompact_bank
    agree: List[float] = []
    banks: List[bool] = []
    max_dlogit = max_demb = 0.0
    unexplained = 0

    def mirrored_compact(ccfg, *args):
        got = compact(ccfg, *args)
        want = compact(ccfg, *(_to(a, ref_device) for a in args))
        banks.append(all(_identical(g, w) for g, w in zip(got, want)))
        return got

    def mirrored_extract(imgs):
        nonlocal max_demb
        emb, low = extract(imgs)
        with torch.no_grad():
            ref_emb, _ = ref.extract_feature(imgs.to(ref_device))
        max_demb = max(max_demb, (emb.float().to(ref_device)
                                  - ref_emb.float()).abs().max().item())
        return emb, low

    def mirrored(*args, **kw):
        nonlocal max_dlogit, unexplained
        watch.begin(1)
        logits, memory = segment(*args, **kw)
        with torch.no_grad():
            ref_logits, _ = ref.segment_frame(*(_to(a, ref_device)
                                                for a in args))
        got = logits.float().to(ref_device)
        want = ref_logits.float()
        valid = want > -1e8
        max_dlogit = max(max_dlogit, (got - want)[valid].abs().max().item())
        ups = [resize_nchw(x, hw, "bilinear") for x in (got, want)]
        agree.append((ups[0].argmax(0) == ups[1].argmax(0)).float().mean()
                     .item())
        unexplained += margin_gate(*ups)[2]
        if on_frame is not None:
            on_frame(segment, args, ups)
        return logits, memory

    ev.model.segment_frame = mirrored
    ev.model.extract_feature = mirrored_extract
    eval_mod.precompact_bank = mirrored_compact
    try:
        ev.evaluate_sequence(seq)
    finally:
        eval_mod.precompact_bank = compact
    return LockstepResult(agree, max_dlogit, max_demb, banks,
                          unexplained + watch.unexplained, watch.parted)


class ChunkLockstepResult(NamedTuple):
    agree: List[float]         # per frame: share of pixels whose masks agree
    max_dlogit: float          # max |Δlogits| over the frames
    max_demb: float            # max |Δ| of the embeddings
    steps: List[int]           # frames per step, in order
    replays: int               # graph replays on the evaluator's side
    unexplained: int = 0       # parted pixels and masks that are no near tie
    masks_parted: int = 0      # decoder top-β mask entries that parted


class _Stash:
    """Wraps a model method to copy its tensor outputs, call by call
    within a step, into buffers of its own: ``latest[k]`` holds the k-th
    call's.  A buffer is allocated at the first, eager call of its call
    index and shapes (a graph's warm-up) and kept, so a captured graph's
    copies fill it again on every replay."""

    def __init__(self, model: AOCNet, name: str):
        self.fn = getattr(model, name)
        self.bufs = {}
        self.latest = {}
        self.calls = 0
        self.per_step = 1
        setattr(model, name, self)

    def begin(self, per_step: int):
        self.calls, self.per_step = 0, per_step

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        k = self.calls % self.per_step
        self.calls += 1
        tensors = ([out] if torch.is_tensor(out)
                   else [t for t in out if torch.is_tensor(t)])
        key = (k, tuple(tuple(t.shape) for t in tensors))
        if key not in self.bufs:
            self.bufs[key] = [torch.empty_like(t) for t in tensors]
        self.latest[k] = self.bufs[key]
        for buf, t in zip(self.bufs[key], tensors):
            buf.copy_(t)
        return out


class _MaskWatch:
    """The decoder's top-β masks (``ConditioningLayer.top_beta``, a strict
    threshold at each object's β-th largest saliency) are discrete
    choices: a saliency within rounding of the threshold flips a pixel in
    or out, and the logits jump (0.07 on one of 20 ensemble calls on the
    H100, and on the CPU under 1e-6 of input noise alone).  The
    evaluator's spatial conditioning layers record φ and the mask call by
    call (``_Stash``, which a graph's replays fill too); the reference's
    compute their own and go on with it, or with the evaluator's when
    ``share``.  An entry where the two masks part counts in ``parted``;
    when shared, also in ``unexplained`` unless the reference's |φ −
    threshold| there is below twice the largest |Δφ| of that call (φ and
    the threshold each move by at most that).  A mask not shared needs
    no such check: its parting reaches the logits the gate reads."""

    def __init__(self, model: AOCNet, ref_model: AOCNet, share: bool):
        def spatial(m):
            return [x for x in m.modules()
                    if isinstance(x, ConditioningLayer)
                    and hasattr(x, "phi_layer")]

        pairs = list(zip(spatial(model), spatial(ref_model)))
        self.phis = [_Stash(a, "saliency") for a, _ in pairs]
        self.masks = [_Stash(a, "top_beta") for a, _ in pairs]
        self.calls = [0] * len(pairs)
        self.share = share
        self.parted = self.unexplained = 0
        for i, (_, b) in enumerate(pairs):
            b.top_beta = self._top_beta(i, b)

    def begin(self, per_step: int):
        for stash in self.phis + self.masks:
            stash.begin(per_step)
        self.calls = [0] * len(self.calls)

    def _top_beta(self, i: int, layer: ConditioningLayer):
        own = layer.top_beta

        def run(phi):
            k = self.calls[i]
            self.calls[i] += 1
            mask = own(phi)
            theirs = self.masks[i].latest[k][0].to(phi.device)
            parted = mask != theirs
            if parted.any():
                d = (self.phis[i].latest[k][0].to(phi.device).float()
                     - phi.float()).abs().max()
                rank = max(1, int(layer.beta_percentage * phi.shape[-1]))
                kth = torch.topk(phi, rank, dim=-1).values[:, -1:]
                far = (phi.float() - kth.float()).abs() >= 2 * d
                self.parted += int(parted.sum())
                if self.share:
                    self.unexplained += int((parted & far).sum())
            return theirs.to(mask.dtype) if self.share else mask
        return run


def lockstep_chunks(cfg: Config, make_model: Callable[[], AOCNet], seq,
                    kmeans_scores: ScoreFn, device="cuda",
                    ref_device="cpu", share_masks: bool = False,
                    devices=None, own_features: bool = False
                    ) -> ChunkLockstepResult:
    """Stream ``seq`` with a chunked evaluator on ``device``, repeating
    each of its steps eagerly on a reference evaluator on ``ref_device``
    from copies of the step's states and inputs; the masks of every frame
    are compared.  The reference takes the evaluator's features of the
    step's frames (its own are computed too, for ``max_demb``), as
    ``lockstep_masks`` hands the reference the evaluator's
    ``segment_frame`` inputs: in mixed matching the operands are rounded
    to bf16, and embeddings 2e-5 apart round to different bf16 values
    now and then, which alone flips near-tied pixels.  A frame's decision
    scores for the gate are the upsampled logits of a single variant,
    or the ensemble's mean probabilities × exist, both sides' computed on
    ``ref_device`` from their logits.  Bank compaction runs between steps
    on the evaluator's side only (``lockstep_masks`` holds it); a join
    frame's step is repeated with its label.  ``share_masks``: see the
    module's docstring.  Convolutions run without TF32 on both sides.

    ``devices``: the evaluator's (the reference runs on ``ref_device``
    alone): with the sharded ensemble each frame's ``sharded_step`` is
    held against the one-device ``chunk_step``.  ``own_features``: the
    reference embeds its frames itself (the sharded ensemble's flip twin
    embeds alone where the one-device step batches it with its scale)."""
    ev = Evaluator(cfg, make_model(), device=device,
                   kmeans_scores=kmeans_scores, devices=devices)
    ref = Evaluator(cfg, make_model(), device=ref_device,
                    kmeans_scores=kmeans_scores, devices=[ref_device])
    torch.backends.cudnn.allow_tf32 = False
    feats = _Stash(ev.model, "extract_feature")
    logits, ref_logits = (_Stash(m, "segment_frame")
                          for m in (ev.model, ref.model))
    watch = _MaskWatch(ev.model, ref.model, share_masks)
    ref_extract = ref.model.extract_feature
    run = ev.run_chunk
    n_groups, n_var = len(ev.variants.groups), len(ev.variants.flips)
    agree: List[float] = []
    steps: List[int] = []
    diffs = {"logit": 0.0, "emb": 0.0, "unexplained": 0, "group": 0}

    def evaluator_features(imgs):
        emb, _ = ref_extract(imgs)
        got = tuple(t.to(ref_device) for t in feats.latest[diffs["group"]])
        diffs["group"] += 1
        diffs["emb"] = max(diffs["emb"], (got[0].float() - emb.float()
                                          ).abs().max().item())
        return got

    if not own_features:
        ref.model.extract_feature = evaluator_features

    def scores(stash, k, ori_hw, em, side):
        """Frame ``k``'s decision scores from one side's logits, its
        variants' probabilities added in that side's order."""
        calls = [stash.latest[k * n_var + j][0].float().to(ref_device)
                 for j in range(n_var)]
        if n_var == 1:
            return resize_nchw(calls[0], ori_hw, "bilinear")
        total = None
        for part in side.sum_order():
            probs = None
            for v in part:
                p = ref._probs(calls[v], ori_hw, v)
                probs = p if probs is None else probs + p
            total = probs if total is None else total + probs
        return total / n_var * em[:, None, None]

    def mirrored(sts, io, ori_hw, join=None):
        k_n = io.frames[0].shape[0]
        sts_ref = [st.copy_to(ref_device) for st in sts]
        io_ref = io.copy_to(ref_device)
        feats.begin(n_groups)
        logits.begin(k_n * n_var)
        watch.begin(k_n * n_var)
        run(sts, io, ori_hw, join)
        ref_logits.begin(k_n * n_var)
        diffs["group"] = 0
        ref.chunk_step(io_ref, sts_ref, ori_hw,
                       None if join is None else join.to(ref_device))
        got = io.preds.to(ref_device)
        for k in range(k_n):
            parted = got[k] != io_ref.preds[k]
            agree.append((~parted).float().mean().item())
            for j in range(n_var):
                want = ref_logits.latest[k * n_var + j][0].float()
                valid = want > -1e8
                d = (logits.latest[k * n_var + j][0].float().to(ref_device)
                     - want)[valid]
                diffs["logit"] = max(diffs["logit"], d.abs().max().item())
            diffs["unexplained"] += margin_gate(
                scores(logits, k, ori_hw, io_ref.em, ev),
                scores(ref_logits, k, ori_hw, io_ref.em, ref), parted)[2]
        steps.append(k_n)

    ev.run_chunk = mirrored
    ev.evaluate_sequence(seq)
    return ChunkLockstepResult(agree, diffs["logit"], diffs["emb"], steps,
                               ev.replays,
                               diffs["unexplained"] + watch.unexplained,
                               watch.parted)
