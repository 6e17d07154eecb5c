"""How far the chunked evaluator's masks stay from the frame-by-frame
evaluator's, and why.

    python -m rvos_tpu_torch.cli.chunk_agreement [--frames 12]
        [--size 481 849] [--layout occupancy] [--device cuda]

The two paths run the same function on the same state, but the chunked
one embeds K frames as one batch: a convolution over a batch of 5 may
take other algorithms than over one frame, and round differently.  For
the preset's compute (bf16 on a card) and for parity mode (float32
compute and matching, TF32 off), this streams a synthetic video (the
``resnet101_aocnet`` preset, random weights from ``--seed``) chunked
(``TEST_FRAME_CHUNK=5``) and frame by frame and prints each frame's
mask agreement, and the largest difference between the first 5 frames'
embeddings from one batch-5 pass and from five batch-1 passes (absolute,
and over the largest embedding value).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="resnet101_aocnet")
    p.add_argument("--layout", default="occupancy")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--size", type=int, nargs=2, default=(481, 849))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import BANK_LAYOUTS, get_config
    from ..data import SyntheticEval
    from ..data.transforms import frame_u8
    from ..engine import Evaluator
    from ..models import AOCNet
    from ..weights import init_random_

    base = get_config(args.config, **BANK_LAYOUTS[args.layout])
    weights = init_random_(AOCNet(base), torch.Generator().manual_seed(
        args.seed)).state_dict()
    seq = SyntheticEval(size=tuple(args.size), n_seqs=1,
                        n_frames=args.frames, obj_num=3)[0]
    modes = {"preset": {}, "parity": dict(MATCHING_DTYPE="float32",
                                          EVAL_COMPUTE_DTYPE="float32")}
    for mode, kw in modes.items():
        out = {}
        for chunk in (5, 1):
            cfg = base.replace(TEST_FRAME_CHUNK=chunk, **kw)
            model = AOCNet(cfg)
            model.load_state_dict(weights)
            ev = Evaluator(cfg, model, device=args.device)
            out[chunk] = ev.evaluate_sequence(seq)["results"]
        agree = [round(float((out[5][k] == m).mean()), 4)
                 for k, m in sorted(out[1].items())]
        x = torch.from_numpy(np.stack([frame_u8(seq[i]["current_img"])
                                       for i in range(5)])).to(ev.device)
        with torch.no_grad():
            batch = ev._embed(x)[0].float()
            single = torch.cat([ev._embed(x[i:i + 1])[0] for i in range(5)]
                               ).float()
        d = (batch - single).abs().max().item()
        print(f"{mode} ({ev.dtype}, {args.layout}, {ev.device}): mask "
              f"agreement chunked vs frame by frame per frame {agree}; "
              f"batch-5 vs batch-1 embeddings max |d| {d:.3e} "
              f"({d / batch.abs().max().item():.3e} of the largest)",
              flush=True)


if __name__ == "__main__":
    main()
