"""The multi-scale + flip ensemble ("MF") of the port's evaluator against
the JAX evaluator on the CPU, and the port's draws of the JAX package's
k-means init scores (``ops.prng``).

Setting: ``MF_KW`` of ``tests/torch_port_cases.py`` (scales 1.0 and 1.3
with flip: four variants, 33×33 and 49×49 frames; float32 matching).
Weights go across with ``from_jax_params``; neither side gets a
``kmeans_scores`` hook, so each draws its own default scores.  The JAX
evaluator runs with ``TEST_ENSEMBLE_SHARD=False``: ``tests/conftest.py``
makes 8 virtual CPU devices, on which it would otherwise shard the
ensemble, a path the port leaves to its multi-GPU slice
(``test_torch_port_parallel_ensemble.py``).

The four JAX references run one after the other in this process: frame
by frame (R1), the host post-processing path for the four variants and
for one (R3, R4), and chunks of 2 with a join frame (R2).  The later
ones reuse the programs the earlier ones compiled that they share (the
weights' initialisation, the ensemble's one-frame step, the first
frame's embeddings), through JAX's compilation cache."""

import jax
import numpy as np
import pytest
import torch

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.data import SyntheticEval as TSyntheticEval
from rvos_tpu_torch.engine import Evaluator as TEvaluator
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.ops import prng
from rvos_tpu_torch.weights import init_random_
from torch_port_cases import (MF_KW, SIZE, JoinObject2AtFrame3,
                              assert_masks_agree, assert_states_equal,
                              jax_init, run_both)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def variables(tmp_path_factory):
    """The JAX model's own weights at ``MF_KW``, made once a run."""
    return jax_init(tmp_path_factory, "mf_init", MF_KW)


@pytest.fixture(scope="module")
def by_frame(variables):
    """R1: MF frame by frame (``TEST_FRAME_CHUNK=1``)."""
    return run_both(variables, TEST_FRAME_CHUNK=1)


def test_ensemble_by_frame_matches_jax(by_frame):
    want, _, got, ev = by_frame
    assert_masks_agree(want, got["results"])
    assert got["frames"] == 5
    assert ev.variants.flips == (False, True, False, True)
    assert ev.variants.groups == ((0, 1), (2, 3))


def test_ensemble_states_match_jax(by_frame):
    """Every variant keeps its own state — a flip twin's bank holds the
    mirrored labels — and each equals the JAX evaluator's."""
    from rvos_tpu_torch.ops import resize_nchw

    _, jstates, _, ev = by_frame
    assert len(ev._last_states) == 4
    assert_states_equal(jstates, ev._last_states)
    base, twin = ev._last_states[:2]
    assert base is not twin and base.version == twin.version == 3
    # the mirrored first annotation, downscaled, opens the twin's bank:
    # not the mirror of the base's downscaled one (nearest sampling is
    # not symmetric)
    gt = torch.from_numpy(TSyntheticEval(size=SIZE, n_seqs=1, n_frames=1)[0][
        0]["current_label"].astype(np.int64))
    want = resize_nchw(gt.flip(1), (9, 9), "nearest")
    assert torch.equal(twin.ref_lab[0], want)
    assert not torch.equal(want, base.ref_lab[0].flip(1))

@pytest.fixture(scope="module", params=["ensemble", "single"])
def host_path(request, variables):
    """R3 (the four MF variants) and R4 (one scale, no flip) through the
    host post-processing path (``TEST_FUSED_POSTPROCESS=False``): every
    frame alone, each variant's step, the exist-masked probabilities
    averaged, then the argmax, the join splice and the entropy gate."""
    kw = {} if request.param == "ensemble" else dict(TEST_FLIP=False,
                                                     TEST_MULTISCALE=(1.0,))
    return request.param, run_both(variables, wrap=JoinObject2AtFrame3,
                                   TEST_FUSED_POSTPROCESS=False, **kw)


def test_host_path_matches_jax(host_path):
    kind, (want, jstates, got, ev) = host_path
    assert_masks_agree(want, got["results"])
    assert ev.chunk_n == 1 and not ev.fused
    assert len(ev._last_states) == (4 if kind == "ensemble" else 1)
    assert_states_equal(jstates, ev._last_states)
    assert (got["results"]["00003.jpg"][2:9, 20:31] == 2).all()


@pytest.fixture(scope="module")
def chunked_join(variables):
    """R2: MF in chunks of 2 (``MEM_EVERY=2`` cuts them at frames 1-2 and
    4; frame 3 is a join frame, frame 5 a ragged tail; the JAX
    evaluator's ``_step_ensemble_chunk``), object 2 annotated from frame
    3 on."""
    return run_both(variables, wrap=JoinObject2AtFrame3, TEST_FRAME_CHUNK=2)


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
        cfg = tconfigs.tiny_test(**dict(MF_KW, TEST_MULTISCALE=(1.0, 1.3),
                                        MATCHING_DTYPE="mixed",
                                        TEST_FRAME_CHUNK=chunk))
        ev = TEvaluator(cfg, init_random_(TAOCNet(cfg),
                                          torch.Generator().manual_seed(3)),
                        device="cpu")
        out[chunk] = ev.evaluate_sequence(
            TSyntheticEval(size=SIZE, n_seqs=1, n_frames=7)[0])["results"]
        assert [tuple(st.prev_lab.shape) for st in ev._last_states] == [
            (9, 9), (9, 9), (13, 13), (13, 13)]
    a, b = out[1], out[2]
    assert sorted(a) == sorted(b) and len(a) == 6
    diff = sum(int((a[k] != b[k]).sum()) for k in a)
    assert diff / sum(m.size for m in a.values()) < 0.005


@pytest.mark.parametrize("frame,n_obj,n_rows", [
    (0, 3, 1), (1, 4, 243), (5, 11, 16384), (7, 1, 17), (123, 2, 4096),
    (2**31 - 1, 3, 5)])
def test_kmeans_draws_match_jax(frame, n_obj, n_rows):
    """``fold_in``/``split``/``uniform`` of the JAX evaluator's k-means
    keys, bit for bit, for one row (R = 1), odd R, and a frame index at
    the int32 limit."""
    key = jax.random.fold_in(jax.random.PRNGKey(42), np.int32(frame))
    want = np.stack([np.asarray(jax.random.uniform(k, (n_rows,), minval=0.5,
                                                   maxval=1.0))
                     for k in jax.random.split(key, n_obj)])
    got = prng.kmeans_init_scores([frame], n_obj, n_rows)[0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        prng.kmeans_keys([frame], n_obj)[0].numpy(),
        np.asarray(jax.random.split(key, n_obj)))


@pytest.mark.parametrize("seed,lo,hi", [(9, -0.3, 2.1), (3, 0.0, 1.0)])
def test_uniform_matches_jax(seed, lo, hi):
    """A range whose scale and shift round: one rounding, as JAX's."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4097,),
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.prng_key(seed), 4097, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_evaluator_draws_blocks_of_frames():
    """The evaluator's default scores for a step are the draws of its
    frames however the frames fall into the blocks it draws (a prefix
    for a shorter bank)."""
    cfg = tconfigs.tiny_test(**MF_KW)
    ev = TEvaluator(cfg, TAOCNet(cfg), device="cpu")
    want = prng.kmeans_init_scores(range(60), 3, 243)
    for frames in ([1], [2, 3], [31, 32, 33], [59], [4]):
        np.testing.assert_array_equal(ev.init_scores(frames, 243).numpy(),
                                      want[frames[0]:frames[-1] + 1].numpy())
    np.testing.assert_array_equal(ev.init_scores([4], 100).numpy(),
                                  want[4:5, :, :100].numpy())
