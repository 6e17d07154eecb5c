"""How far small float noise compounds through the streaming evaluator.

    python -m rvos_tpu_torch.cli.noise_sensitivity [--eps 3e-5] [--seeds 4]
        [--frames 6] [--layout cap0 ...] [--device cpu]

Runs the small parity setting of the card-vs-CPU checks
(``engine.lockstep.parity_config``, random weights from a seed) under
each bank layout: once as is, then once per seed with Gaussian noise of
standard deviation ``--eps`` added to every embedding that
``extract_feature`` returns — about the difference between the card's
and the CPU's embeddings.  Prints one JSON line per layout: for each
seed, the lowest per-frame share of pixels whose masks agree with the
clean run.  Masks feed the bank, so a pixel that flips early can move
much of a later frame; this is why card and CPU are compared frame by
frame (``engine.lockstep``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--eps", type=float, default=3e-5)
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--layout", nargs="*", default=None,
                   help="bank layouts (default: all of configs.BANK_LAYOUTS)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..configs import BANK_LAYOUTS
    from ..data import SyntheticEval
    from ..engine import Evaluator
    from ..engine.lockstep import parity_config, parity_scores
    from ..models import AOCNet
    from ..weights import init_random_

    def run(cfg, noise_seed):
        model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
        ev = Evaluator(cfg, model, device=args.device,
                       kmeans_scores=parity_scores)
        if noise_seed is not None:
            g = torch.Generator(device=ev.device).manual_seed(noise_seed)
            extract = ev.model.extract_feature

            def noisy(imgs):
                emb, low = extract(imgs)
                return emb + args.eps * torch.randn(
                    emb.shape, generator=g, device=emb.device,
                    dtype=emb.dtype), low
            ev.model.extract_feature = noisy
        seq = SyntheticEval(size=(65, 65), n_seqs=1, n_frames=args.frames)[0]
        return ev.evaluate_sequence(seq)["results"]

    for layout in args.layout or list(BANK_LAYOUTS):
        cfg = parity_config(layout)
        clean = run(cfg, None)
        worst = []
        for seed in range(args.seeds):
            noisy = run(cfg, seed)
            worst.append(min(float((noisy[k] == v).mean())
                             for k, v in clean.items()))
        print(json.dumps({"layout": layout, "eps": args.eps,
                          "device": args.device,
                          "min_frame_agreement_per_seed": worst}), flush=True)


if __name__ == "__main__":
    main()
