"""The port's multi-scale + flip ensemble in chunks against the JAX
evaluator's ``_step_ensemble_chunk`` on the CPU, with a join frame, and
the chunked ensemble against its own frame-by-frame run in mixed
matching.  Setting and helpers: ``test_torch_port_ensemble.py``."""

import numpy as np
import pytest
import torch

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import SyntheticEval
from rvos_tpu_torch.engine import Evaluator
from rvos_tpu_torch.models import AOCNet
from rvos_tpu_torch.weights import init_random_
from test_torch_port_ensemble import (MF_KW, JoinObject2AtFrame3,
                                      assert_masks_agree, assert_states_equal,
                                      run_both)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def chunked_join():
    """R2: MF in chunks of 2 (``MEM_EVERY=2`` cuts them at frames 1-2 and
    4; frame 3 is a join frame, frame 5 a ragged tail), object 2
    annotated from frame 3 on."""
    return run_both(wrap=JoinObject2AtFrame3, TEST_FRAME_CHUNK=2)


def test_chunked_ensemble_matches_jax(chunked_join):
    want, _, got, ev = chunked_join
    assert_masks_agree(want, got["results"])
    assert ev.chunk_n == 2 and ev.replays == ev.captures == 0


def test_ensemble_join_frame_matches_jax(chunked_join):
    """The join frame's label is spliced into the mask and every
    variant's bank appends (frames 0, 2, 3 and 4: the join and the
    MEM_EVERY frames), each bank equal to the JAX evaluator's."""
    want, jstates, got, ev = chunked_join
    new = np.zeros(want["00003.jpg"].shape, bool)
    new[2:9, 20:31] = True
    assert (got["results"]["00003.jpg"][new] == 2).all()
    assert any((m == 2).any() for k, m in got["results"].items()
               if k > "00003.jpg")
    assert_states_equal(jstates, ev._last_states)
    assert [st.version for st in ev._last_states] == [4] * 4


def test_chunked_ensemble_matches_frame_by_frame_mixed():
    """Mixed matching, scales 1.0 and 1.3 with flip (33×33 and 49×49
    frames): chunks of 2 against frame by frame, under 0.5 % of the
    video's pixels apart (the bar of the single-scale chunk test); the
    two scales' states keep their own sizes."""
    out = {}
    for chunk in (1, 2):
        cfg = tiny_test(**dict(MF_KW, TEST_MULTISCALE=(1.0, 1.3),
                               MATCHING_DTYPE="mixed", TEST_FRAME_CHUNK=chunk))
        ev = Evaluator(cfg, init_random_(AOCNet(cfg),
                                         torch.Generator().manual_seed(3)),
                       device="cpu")
        out[chunk] = ev.evaluate_sequence(
            SyntheticEval(size=(33, 33), n_seqs=1, n_frames=7)[0])["results"]
        assert [tuple(st.prev_lab.shape) for st in ev._last_states] == [
            (9, 9), (9, 9), (13, 13), (13, 13)]
    a, b = out[1], out[2]
    assert sorted(a) == sorted(b) and len(a) == 6
    diff = sum(int((a[k] != b[k]).sum()) for k in a)
    assert diff / sum(m.size for m in a.values()) < 0.005
