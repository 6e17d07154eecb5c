"""The host post-processing path (``TEST_FUSED_POSTPROCESS=False``) of the
port's evaluator against the JAX evaluator's on the CPU, for the
multi-scale + flip ensemble and for a single variant, on a video with a
join frame.  Every frame runs alone: each variant's step, the
exist-masked probabilities averaged, then the argmax, the join splice
and the entropy gate.  Setting and helpers:
``test_torch_port_ensemble.py``."""

import pytest

from test_torch_port_ensemble import (JoinObject2AtFrame3, assert_masks_agree,
                                      assert_states_equal, run_both)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["ensemble", "single"])
def host_path(request):
    """R3 (the four MF variants) and R4 (one scale, no flip)."""
    kw = {} if request.param == "ensemble" else dict(TEST_FLIP=False,
                                                     TEST_MULTISCALE=(1.0,))
    return request.param, run_both(wrap=JoinObject2AtFrame3,
                                   TEST_FUSED_POSTPROCESS=False, **kw)


def test_host_path_matches_jax(host_path):
    kind, (want, jstates, got, ev) = host_path
    assert_masks_agree(want, got["results"])
    assert ev.chunk_n == 1 and not ev.fused
    assert len(ev._last_states) == (4 if kind == "ensemble" else 1)
    assert_states_equal(jstates, ev._last_states)
    assert (got["results"]["00003.jpg"][2:9, 20:31] == 2).all()
