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

runs the evaluator on CUDA (the kernels) against a CPU reference (their
plain versions).  ``whole_video_agreement`` is the plain comparison of
two independent runs; it also covers the state updates between frames,
but holds only while no flipped pixel reaches the bank.
``parity_config(layout)`` and ``parity_scores`` are the small
parity-mode setting both checks run in.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from ..configs import BANK_LAYOUTS, Config, tiny_test
from ..models import AOCNet, DecoderMemory
from ..ops.resize import resize_nchw
from . import eval as eval_mod
from .eval import Evaluator, ScoreFn


class LockstepResult(NamedTuple):
    agree: List[float]         # per frame: share of pixels whose masks agree
    max_dlogit: float          # max |Δlogits| over the frames
    max_demb: float            # max |Δ| of the embeddings
    banks_equal: List[bool]    # per bank compaction: identical on both sides


# layouts whose whole-video card and CPU runs of the parity setting agree
# (on an H100); at no cap a pixel flipped by rounding at frame 4 enters
# the bank and frame 5 agrees on 94 % only, so it is held frame by frame
WHOLE_VIDEO_LAYOUTS = ("occupancy", "uniform", "unsegmented")


def parity_config(layout: str) -> Config:
    """``tiny_test`` at 65×65 with 4 object channels, 3 bank slots and
    float32 compute, under bank layout ``layout`` (``BANK_LAYOUTS``); the
    fg-union layout gets a cap below the 867 rows of 3 slots, so that its
    compaction drops rows."""
    cap = dict(MATCHING_MAX_REF_PIXELS=512) if layout == "unsegmented" else {}
    return tiny_test(DATA_RANDOMCROP=(65, 65), MODEL_MULTI_LOCAL_DISTANCE=(2, 4),
                     MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None,
                     TEST_BANK_CAPACITY=3, MEM_EVERY=2,
                     EVAL_COMPUTE_DTYPE="float32", **BANK_LAYOUTS[layout], **cap)


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
                   ref_device="cpu") -> LockstepResult:
    """Stream ``seq`` with an evaluator on ``device``, repeating each
    frame's ``segment_frame`` and each bank compaction on a reference
    model on ``ref_device``.  ``make_model()`` returns a fresh model with
    the weights both use."""
    ev = Evaluator(cfg, make_model(), device=device,
                   kmeans_scores=kmeans_scores)
    ref = make_model().to(device=ref_device, dtype=ev.dtype).eval()
    hw = tuple(seq[0]["current_img"].shape[:2])
    segment, extract = ev.model.segment_frame, ev.model.extract_feature
    compact = eval_mod.precompact_bank
    agree: List[float] = []
    banks: List[bool] = []
    max_dlogit = max_demb = 0.0

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

    def mirrored(*args):
        nonlocal max_dlogit
        logits, memory = segment(*args)
        with torch.no_grad():
            ref_logits, _ = ref.segment_frame(*(_to(a, ref_device)
                                                for a in args))
        got = logits.float().to(ref_device)
        want = ref_logits.float()
        valid = want > -1e8
        max_dlogit = max(max_dlogit, (got - want)[valid].abs().max().item())
        masks = [resize_nchw(x, hw, "bilinear").argmax(0) for x in (got, want)]
        agree.append((masks[0] == masks[1]).float().mean().item())
        return logits, memory

    ev.model.segment_frame = mirrored
    ev.model.extract_feature = mirrored_extract
    eval_mod.precompact_bank = mirrored_compact
    try:
        ev.evaluate_sequence(seq)
    finally:
        eval_mod.precompact_bank = compact
    return LockstepResult(agree, max_dlogit, max_demb, banks)
