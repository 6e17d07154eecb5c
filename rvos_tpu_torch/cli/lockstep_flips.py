"""Where the card's and the CPU's masks part in lock-step, and why.

    python -m rvos_tpu_torch.cli.lockstep_flips [--layout cap0]
        [--matching float32] [--frames 6] [--device cuda]

Runs ``engine.lockstep.lockstep_masks`` in the small parity setting of
``chip_smoke.py`` phase 4 (65×65, random weights from seed 0) and prints
one JSON line per frame: the share of pixels whose masks agree, the max
|Δlogit| of the upsampled logits (valid objects), ``near_ties``, the
pixels whose top-two logits on the CPU lie closer than that, and
``unexplained``, the parted pixels that are no such tie
(``engine.lockstep.margin_gate``, the card checks' gate); the last line
adds what the run fails of that gate (``gate_failures``).  For each
pixel where the masks part it adds the card's and the CPU's labels and
each side's margin ``logit[card label] - logit[CPU label]``, and the
card's frame computed again from the same arguments four ways: as is,
with kernel 2's output (``ops.local_match``) taken from its plain
version on CPU copies of the same inputs, with the layout's global
kernel's so taken, and with both — the label and margin each gives at
the pixel.  On such a frame it also holds kernel 2's output on the card
and its plain version's on the CPU, both float32, against the plain
version in float64: the max and the root mean square of |Δ|/max(|d|, 1)
of each, and the entries where card and CPU differ.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

# the kernel wrapper in ops.matching that each layout's global stream calls
GLOBAL_KERNEL = {"occupancy": "global_seg_map", "uniform": "global_seg",
                 "unsegmented": "global_flat_min", "cap0": "global_flat_min"}


def _on_cpu(fn):
    """Kernel wrapper ``fn`` on CPU copies of its tensor arguments (so its
    plain version, as the CPU side runs it), the result moved back."""
    def run(*args, **kw):
        dev = next(a.device for a in args if torch.is_tensor(a))
        out = fn(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw)
        return out.to(dev)
    return run


@contextlib.contextmanager
def _swapped(**fns):
    """``ops.matching``'s kernel wrappers replaced for a while."""
    from ..ops import matching
    old = {k: getattr(matching, k) for k in fns}
    for k, f in fns.items():
        setattr(matching, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(matching, k, f)


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| / max(|b|, 1), elementwise, in float64."""
    return (a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)


def _dlogit(ups) -> torch.Tensor:
    """|Δ| of the two sides' upsampled logits, 0 on invalid objects."""
    got, want = ups
    return torch.where(want > -1e8, (got - want).abs(), torch.zeros(()))


def kernel2_errors(call) -> dict:
    """One recorded kernel-2 call ``((x, ys, onehot, radii, atrous), out)``:
    the card's output and the CPU plain version's (float32) against the
    plain version in float64 (relative to max(|d|, 1): where d is far
    below the norms, ``‖x‖² + ‖y‖² - 2 x·y`` cancels)."""
    from ..ops import local_match_plain
    (x, ys, onehot, radii, atrous), out = call
    inputs = [t.cpu() for t in (x, ys, onehot)]
    plain = local_match_plain(*inputs, radii, atrous)
    exact = local_match_plain(*inputs, radii, atrous, dtype=torch.float64)
    out = out.cpu()
    card, cpu = _rel(out, exact), _rel(plain, exact)
    return dict(card_vs_f64=card.max().item(), cpu_vs_f64=cpu.max().item(),
                card_vs_f64_rms=card.square().mean().sqrt().item(),
                cpu_vs_f64_rms=cpu.square().mean().sqrt().item(),
                card_vs_cpu=_rel(out, plain).max().item(),
                entries_differ=int((out != plain).sum()), entries=out.numel())


def explain(segment, args, ups, global_kernel: str) -> dict:
    """One lock-step frame (``lockstep_masks``' ``on_frame`` arguments):
    the agreement, max |Δlogit|, near ties and, where the masks part,
    each such pixel with the recomputed variants and kernel 2's errors."""
    from ..engine.lockstep import margin_gate
    from ..ops import matching
    from ..ops.resize import resize_nchw
    got, want = ups
    dl = _dlogit(ups)
    top2 = want.topk(2, dim=0).values
    max_dlogit, _, unexplained = margin_gate(got, want)
    out = dict(agree=(got.argmax(0) == want.argmax(0)).float().mean().item(),
               max_dlogit=max_dlogit,
               near_ties=int((top2[0] - top2[1] < max_dlogit).sum()),
               unexplained=unexplained)
    flips = (got.argmax(0) != want.argmax(0)).nonzero().tolist()
    if not flips:
        return out
    hw = tuple(want.shape[1:])
    local_kernel, glob = matching.local_match, getattr(matching, global_kernel)
    calls = []

    def recorded(*a):
        res = local_kernel(*a)
        calls.append((a, res))
        return res

    def rerun(**swap):
        with torch.no_grad(), _swapped(**swap):
            logits, _ = segment(*args)
        return resize_nchw(logits.float().to(want.device), hw, "bilinear")

    variants = {
        "card_again": rerun(local_match=recorded),
        "kernel2_plain": rerun(local_match=_on_cpu(local_kernel)),
        "global_plain": rerun(**{global_kernel: _on_cpu(glob)}),
        "both_plain": rerun(local_match=_on_cpu(local_kernel),
                            **{global_kernel: _on_cpu(glob)})}
    out["pixels"] = []
    for y, x in flips:
        a, b = int(got[:, y, x].argmax()), int(want[:, y, x].argmax())
        px = dict(pixel=[y, x], card_label=a, cpu_label=b,
                  margin_card=(got[a, y, x] - got[b, y, x]).item(),
                  margin_cpu=(want[a, y, x] - want[b, y, x]).item(),
                  dlogit_at_pixel=dl[:, y, x].max().item())
        for name, v in variants.items():
            px[name] = dict(label=int(v[:, y, x].argmax()),
                            margin=(v[a, y, x] - v[b, y, x]).item())
        out["pixels"].append(px)
    out["kernel2"] = kernel2_errors(calls[0])
    return out


def main(argv=None) -> int:
    from ..configs import BANK_LAYOUTS
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layout", default="cap0", choices=list(BANK_LAYOUTS))
    p.add_argument("--matching", default="float32",
                   choices=("float32", "mixed"))
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data import SyntheticEval
    from ..engine.lockstep import (gate_failures, lockstep_masks,
                                   parity_config, parity_scores)
    from ..models import AOCNet
    from ..weights import init_random_

    cfg = parity_config(args.layout, args.matching)
    frames = []

    def on_frame(segment, fargs, ups):
        res = explain(segment, fargs, ups, GLOBAL_KERNEL[args.layout])
        res = dict(frame=len(frames) + 1, **res)
        frames.append(res)
        print(json.dumps(res), flush=True)

    lock = lockstep_masks(
        cfg, lambda: init_random_(AOCNet(cfg), torch.Generator().manual_seed(0)),
        SyntheticEval(size=(65, 65), n_seqs=1, n_frames=args.frames)[0],
        parity_scores, device=args.device, on_frame=on_frame)
    print(json.dumps(dict(layout=args.layout, matching=args.matching,
                          device=args.device, agree=lock.agree,
                          max_dlogit=lock.max_dlogit,
                          banks_equal=lock.banks_equal,
                          gate_failures=gate_failures(lock))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
