"""The port's default chunked path against the JAX evaluator's
(``_step_fused_chunk``) on the CPU: the ``_Changing`` video of
``test_torch_port_pipeline.py`` (13 frames, a join frame, an
``exist_mask`` change inside a chunk) at ``tiny_test`` with
``TEST_FRAME_CHUNK=3``, once with the JAX draws handed to the port and
once with the port's own default draws (``ops.prng``).  A third run
hands the port the draws it made before it reproduced JAX's (a
``torch.Generator`` seeded with 42 + frame): the comparison must see
them.

    PYTHONPATH=. python tests/test_torch_port_chunks_jax.py [--size 129 129]
        [--frames 12] [--config resnet101_aocnet]

runs the JAX package's own chunked (``TEST_FRAME_CHUNK=5``) and
frame-by-frame evaluators on the setting of
``rvos_tpu_torch.cli.chunk_agreement`` in parity mode (float32 compute
and matching), at the size given, and prints each frame's mask
agreement between the two: whether JAX's own runs part as the port's
do."""

import argparse

import jax
import numpy as np
import pytest
import torch

from rvos_tpu.configs import get_config, tiny_test
from rvos_tpu.data.datasets import SyntheticEval
from rvos_tpu.engine.checkpoint import _flatten
from rvos_tpu.engine.eval import Evaluator
from rvos_tpu.models.aocnet import init_model

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.engine import Evaluator as TEvaluator
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.weights import from_jax_params
from test_torch_port_eval import _jax_kmeans_scores
from test_torch_port_pipeline import _KW, SIZE, _Changing
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

KW = dict(_KW, DATA_RANDOMCROP=SIZE, TEST_FRAME_CHUNK=3)


class _JaxChanging(_Changing):
    def __init__(self):
        self.seq = SyntheticEval(size=SIZE, n_seqs=1, n_frames=13)[0]
        self.seq_name = "changing"


def _generator_scores(frame_idx, n_obj, n_rows):
    g = torch.Generator().manual_seed(42 + frame_idx)
    return 0.5 + 0.5 * torch.rand((n_obj, n_rows), generator=g)


@pytest.fixture(scope="module")
def reference():
    cfg = tiny_test(**KW)
    model, variables = init_model(cfg, jax.random.PRNGKey(0), SIZE)
    want = Evaluator(cfg, model, variables).evaluate_sequence(_JaxChanging())
    return want["results"], variables


def _port(variables, scores):
    cfg = tconfigs.tiny_test(**KW)
    model = TAOCNet(cfg)
    model.load_state_dict(
        from_jax_params(_flatten(jax.device_get(variables["params"]))),
        strict=True)
    ev = TEvaluator(cfg, model, device="cpu", kmeans_scores=scores)
    return ev.evaluate_sequence(_Changing())["results"]


def _agreement(want, got):
    assert sorted(got) == sorted(want) == [f"{i:05d}.jpg" for i in range(1, 13)]
    return [float((got[k] == want[k]).mean()) for k in sorted(want)]


@pytest.mark.parametrize("draws", ["jax_hook", "default"])
def test_chunked_path_matches_jax(reference, draws):
    want, variables = reference
    agree = _agreement(want, _port(variables, _jax_kmeans_scores
                                   if draws == "jax_hook" else None))
    assert min(agree) >= 0.999, agree


def test_other_draws_part_from_jax(reference):
    """The generator draws the port used to make by default: the masks
    part from JAX's (0.445 of a frame by frame 11, PR 6's measurement),
    so the comparison above holds the draws themselves."""
    want, variables = reference
    agree = _agreement(want, _port(variables, _generator_scores))
    print("generator draws against JAX, per frame:",
          [round(a, 4) for a in agree])
    assert min(agree) < 0.9, agree


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="resnet101_aocnet")
    p.add_argument("--size", type=int, nargs=2, default=(129, 129))
    p.add_argument("--frames", type=int, default=12)
    args = p.parse_args(argv)
    size = tuple(args.size)
    base = get_config(args.config, MATCHING_DTYPE="float32",
                      EVAL_COMPUTE_DTYPE="float32")
    _, variables = init_model(base, jax.random.PRNGKey(0), size)
    out = {}
    for chunk in (5, 1):
        cfg = base.replace(TEST_FRAME_CHUNK=chunk)
        from rvos_tpu.models import AOCNet
        out[chunk] = Evaluator(cfg, AOCNet(cfg), variables).evaluate_sequence(
            SyntheticEval(size=size, n_seqs=1, n_frames=args.frames,
                          obj_num=3)[0])["results"]
    agree = [round(float((out[5][k] == m).mean()), 4)
             for k, m in sorted(out[1].items())]
    print(f"JAX {args.config} parity {size[0]}x{size[1]}: mask agreement "
          f"chunked vs frame by frame per frame {agree}", flush=True)


if __name__ == "__main__":
    main()
