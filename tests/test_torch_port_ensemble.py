"""The multi-scale + flip ensemble ("MF") of the port's evaluator against
the JAX evaluator on the CPU, frame by frame, and the port's draws of the
JAX package's k-means init scores (``ops.prng``).

Setting (``MF_KW``, that of ``tests/test_eval_ensemble.py``):
``tiny_test`` at 33×33 with radii (1, 2), 3 object channels, no size
cap, ``TEST_FLIP`` and ``TEST_MULTISCALE=(1.0, 1.3)`` — four variants,
33×33 and 49×49 frames (9×9 and 13×13 embeddings; the 0.8 of
``tests/test_eval_ensemble.py`` snaps back to 33×33 here, and would hide
a mix-up of scales) — ``MEM_EVERY=2`` and float32 matching
(``tiny_test``'s own: the JAX package's XLA global matching computes
float32 even in mixed mode, while the port follows its Pallas kernels).
Weights go across with ``from_jax_params``; neither side gets a
``kmeans_scores`` hook, so each draws its own default scores.  The JAX
evaluator runs with ``TEST_ENSEMBLE_SHARD=False``: ``tests/conftest.py``
makes 8 virtual CPU devices, on which it would otherwise shard the
ensemble, a path the port leaves to its multi-GPU slice.  The helpers
here serve ``test_torch_port_ensemble_*.py`` too; each file runs its own
JAX references (JAX ensemble runs compile slowly on the CPU)."""

import functools

import jax
import numpy as np
import pytest
import torch

from rvos_tpu.configs import tiny_test
from rvos_tpu.data.datasets import SyntheticEval
from rvos_tpu.engine.checkpoint import _flatten
from rvos_tpu.engine.eval import Evaluator
from rvos_tpu.models.aocnet import AOCNet, init_model

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.data import SyntheticEval as TSyntheticEval
from rvos_tpu_torch.engine import Evaluator as TEvaluator
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.ops import prng
from rvos_tpu_torch.weights import from_jax_params
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

SIZE = (33, 33)
MF_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
             MODEL_MAX_OBJ_NUM=3, TEST_MAX_SIZE=None, TEST_FLIP=True,
             TEST_MULTISCALE=(1.0, 1.3), MEM_EVERY=2,
             TEST_ENSEMBLE_SHARD=False)


@functools.lru_cache(maxsize=1)
def jax_variables():
    cfg = tiny_test(**MF_KW)
    return init_model(cfg, jax.random.PRNGKey(0), SIZE)[1]


class JoinObject2AtFrame3:
    """The 6-frame synthetic video with object 2 left out of frame 0's
    annotation and first annotated on frame 3 (a YouTube-VOS style late
    object, spliced in and added to every variant's bank there)."""

    def __init__(self, seq):
        self.seq = seq

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        s = self.seq[idx]
        if idx == 0:
            s["current_label"][s["current_label"] == 2] = 0
        if idx == 3:
            lab = np.zeros(SIZE, np.uint8)
            lab[2:9, 20:31] = 2
            s["current_label"] = lab
        return s


def run_both(n_frames=6, wrap=None, **kw):
    """The synthetic video (``wrap``-ped) through the JAX evaluator and the
    port's at ``MF_KW`` updated by ``kw`` → (JAX results, JAX states, port
    output, port evaluator)."""
    wrap = wrap or (lambda s: s)
    cfg = tiny_test(**dict(MF_KW, **kw))
    variables = jax_variables()
    jev = Evaluator(cfg, AOCNet(cfg), variables)
    want = jev.evaluate_sequence(wrap(SyntheticEval(
        size=SIZE, n_seqs=1, n_frames=n_frames)[0]))["results"]

    tcfg = tconfigs.tiny_test(**dict(MF_KW, **kw))
    tmodel = TAOCNet(tcfg)
    tmodel.load_state_dict(
        from_jax_params(_flatten(jax.device_get(variables["params"]))),
        strict=True)
    ev = TEvaluator(tcfg, tmodel, device="cpu")
    got = ev.evaluate_sequence(wrap(TSyntheticEval(
        size=SIZE, n_seqs=1, n_frames=n_frames)[0]))
    return want, jev._last_states, got, ev


def assert_masks_agree(want, got, n_frames=6):
    """Every frame's masks agree on ≥ 99.9 % of pixels."""
    assert sorted(got) == sorted(want) == [f"{i:05d}.jpg"
                                           for i in range(1, n_frames)]
    assert any(len(np.unique(m)) > 1 for m in want.values())
    for name, mask in want.items():
        g = got[name]
        assert g.shape == mask.shape == SIZE and g.dtype == np.uint8
        agree = (g == mask).mean()
        assert agree >= 0.999, (name, agree)


def assert_states_equal(jstates, tstates):
    """Each variant's state after the video: previous labels, bank slot
    validity, and the labels of every valid bank slot, equal; an
    ensemble's scales keep states of their own sizes."""
    assert len(jstates) == len(tstates)
    if len(tstates) > 1:
        assert len({tuple(st.prev_lab.shape) for st in tstates}) > 1
    for v, (js, ts) in enumerate(zip(jstates, tstates)):
        valid = np.asarray(js.slot_valid)
        np.testing.assert_array_equal(ts.slot_valid.numpy(), valid, str(v))
        np.testing.assert_array_equal(ts.prev_lab.numpy(),
                                      np.asarray(js.prev_lab), str(v))
        lab = np.asarray(js.ref_lab)[valid > 0]
        np.testing.assert_array_equal(ts.ref_lab.numpy()[valid > 0], lab,
                                      str(v))


@pytest.fixture(scope="module")
def by_frame():
    """R1: MF frame by frame (``TEST_FRAME_CHUNK=1``)."""
    return run_both(TEST_FRAME_CHUNK=1)


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
