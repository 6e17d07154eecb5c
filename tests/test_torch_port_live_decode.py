"""AOC-Net's decode of the live object channels only, on the CPU:
``segment_frame(..., live=n)`` against the decode of all
``MODEL_MAX_OBJ_NUM`` channels on two frames (the second reading the
decoder memory), the state's write-back of a live memory, and the
evaluator's videos against its run over all channels (the live-count
helper made to return ``O``): one object, an object count that grows
where the sequence lists it up front, and one that grows where it does
not."""

import numpy as np
import pytest
import torch

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import SyntheticEval
from rvos_tpu_torch.device import configure_precision
from rvos_tpu_torch.engine import Evaluator
import rvos_tpu_torch.engine.eval as eval_mod
from rvos_tpu_torch.models import AOCNet, DecoderMemory
from rvos_tpu_torch.weights import init_random_
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

O = 4
H = W = 33


# the decode of ``live`` channels against all ``O``'s, by dtype: a batch
# of another size rounds apart on the CPU by ~1e-5 of the logits' scale
# in float32 and ~1e-14 in float64 (measured), so float64 holds the
# function and float32 the rounding
_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["float64", "float32"])
def frames(request):
    """A random model and the inputs of two frames at 33×33 (a 9×9
    embedding): objects 1 and 2 in the bank and the previous frame."""
    dt = request.param
    cfg = tiny_test(MODEL_MULTI_LOCAL_DISTANCE=(2, 4), MODEL_MAX_OBJ_NUM=O)
    configure_precision(cfg)
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(1))
    model = model.eval().to(dt)
    imgs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, H, W, 3))).to(dt)
    with torch.no_grad():
        emb, low = model.extract_feature(imgs)
    h, w = emb.shape[1:3]
    lab = torch.zeros((h, w), dtype=torch.long)
    lab[1:4, 1:5] = 1
    lab[5:8, 2:7] = 2
    onehot = torch.eye(O, dtype=dt)[lab]
    prev_onehot = torch.eye(O, dtype=dt)[lab.roll(1, dims=1)]
    scores = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.0, (O, h * w)).astype(np.float32))
    return model, emb, low, onehot, prev_onehot, scores


def _decode(frames, obj_valid, memory, k, live=None):
    model, emb, low, onehot, prev_onehot, scores = frames
    with torch.no_grad():
        return model.segment_frame(
            emb[k], low[k], emb[0][None], onehot[None],
            torch.ones(1, dtype=emb.dtype), emb[k - 1], prev_onehot,
            obj_valid, memory, scores, live=live)


def _assert_close(got, want, tol):
    """Within ``tol`` of ``want``'s largest magnitude."""
    gap = (got - want).abs().max().item()
    assert gap <= tol * want.abs().max().item(), gap


@pytest.mark.parametrize("live", [1, 2, O])
def test_live_decode_matches_all_channels(frames, live):
    """The live channels' logits and memory equal the decode of all
    channels' (``_TOL``), with the same argmax; every dead channel reads
    −1e9.  At ``live=O`` one channel inside the count is dead (an object
    that joins later)."""
    emb = frames[1]
    h, w = emb.shape[1:3]
    tol = _TOL[emb.dtype]
    n_valid = live if live < O else O - 1
    obj_valid = (torch.arange(O) < n_valid).to(emb.dtype)
    empty = DecoderMemory.empty(O, (h + 1) // 2, (w + 1) // 2, 256,
                                dtype=emb.dtype)
    full_mem, got_mem = empty, empty
    for k in (1, 2):        # the second frame reads the memory
        want, full_mem = _decode(frames, obj_valid, full_mem, k)
        got, new_mem = _decode(frames, obj_valid, got_mem, k, live)
        assert got.shape == want.shape == (O, h, w)
        assert new_mem.slots.shape[1] == live
        _assert_close(got[:n_valid], want[:n_valid], tol)
        assert torch.equal(got.argmax(0), want.argmax(0))
        assert (got[n_valid:] == -1e9).all()
        _assert_close(new_mem.slots, full_mem.slots[:, :live], tol)
        assert new_mem.valid.tolist() == [True, True]
        # the evaluator keeps an O-channel memory, the dead slots zero
        got_mem = DecoderMemory(empty.slots.clone(), new_mem.valid)
        got_mem.slots[:, :live] = new_mem.slots


def test_state_carries_live_slots_only():
    """``_SeqState.carry`` writes a live memory into the first channels
    and leaves the others as they were."""
    cfg = tiny_test(MODEL_MAX_OBJ_NUM=O)
    st = eval_mod._SeqState(cfg, 9, 9, 100, torch.float32, "cpu")
    st.memory.slots.fill_(7.0)
    mem = DecoderMemory(torch.rand((2, 2, 256, 5, 5)),
                        torch.ones(2, dtype=torch.bool))
    st.carry(torch.ones((9, 9, 100)), torch.ones((9, 9), dtype=torch.long),
             mem)
    assert torch.equal(st.memory.slots[:, :2], mem.slots)
    assert (st.memory.slots[:, 2:] == 7.0).all()
    assert st.memory.valid.all() and (st.prev_lab == 1).all()


SIZE = (33, 33)
_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
           MODEL_MAX_OBJ_NUM=O, TEST_MAX_SIZE=None, TEST_BANK_CAPACITY=3,
           MEM_EVERY=3, TEST_FRAME_CHUNK=3)


class _Growing:
    """A 10-frame synthetic video with object 1 on frame 0 and object 2
    joining on frame 4 (a join frame): ``obj_num`` 1, then 2.  With
    ``listed`` the sequence says so up front (``obj_nums``, as
    ``data.VOSTest``'s sequences do)."""

    def __init__(self, listed: bool):
        self.seq = SyntheticEval(size=SIZE, n_seqs=1, n_frames=10)[0]
        self.seq_name = "growing"
        if listed:
            self.obj_nums = [1 if i < 4 else 2 for i in range(10)]

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        s = self.seq[idx]
        s["meta"]["obj_num"] = 1 if idx < 4 else 2
        if idx == 0:
            s["current_label"][s["current_label"] == 2] = 0
        if idx == 4:
            lab = np.zeros(SIZE, np.uint8)
            lab[2:9, 20:31] = 2
            s["current_label"] = lab
        return s


def _run(seq, padded: bool, monkeypatch):
    """The evaluator's masks and ``decoded_channels`` on ``seq``; with
    ``padded`` every video decodes all ``O`` channels."""
    with monkeypatch.context() as m:
        if padded:
            m.setattr(eval_mod, "live_channels", lambda s, n, o: o)
        cfg = tiny_test(**_KW)
        ev = Evaluator(cfg, init_random_(AOCNet(cfg),
                                         torch.Generator().manual_seed(1)),
                       device="cpu")
        out = ev.evaluate_sequence(seq)
    return out["results"], ev.decoded_channels


def _assert_same(a, b, names):
    for k in names:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_one_object_video_matches_all_channels(monkeypatch):
    """One object under ``MODEL_MAX_OBJ_NUM=4``: two channels decoded a
    frame, and the masks of every frame equal the decode of all four's."""
    seq = SyntheticEval(size=SIZE, n_seqs=1, n_frames=8, obj_num=1)[0]
    got, n_live = _run(seq, False, monkeypatch)
    want, n_all = _run(seq, True, monkeypatch)
    assert sorted(got) == sorted(want) and len(got) == 7
    _assert_same(got, want, want)
    assert n_live == 2 * 7 and n_all == O * 7


def test_listed_growth_matches_all_channels(monkeypatch):
    """Object counts listed up front ([1, 1, 1, 1, 2, ...]): three channels
    from frame 1 on, object 2's decoded as a dead channel until it joins,
    and every frame's mask equals the decode of all channels'."""
    got, n_live = _run(_Growing(listed=True), False, monkeypatch)
    want, _ = _run(_Growing(listed=True), True, monkeypatch)
    assert len(got) == 9
    _assert_same(got, want, want)
    assert n_live == 3 * 9
    assert (got["00004.jpg"][2:9, 20:31] == 2).all()


def test_unlisted_growth_falls_back_to_all_channels(monkeypatch):
    """Object counts not listed: frame 0's count (two channels) until
    frame 4 brings object 2, then all four for the rest of the video.
    Frames before the growth equal the decode of all channels'; the video
    runs to its end with object 2 in its masks."""
    got, n_live = _run(_Growing(listed=False), False, monkeypatch)
    want, _ = _run(_Growing(listed=False), True, monkeypatch)
    assert sorted(got) == sorted(want) and len(got) == 9
    _assert_same(got, want, [f"{i:05d}.jpg" for i in range(1, 4)])
    assert n_live == 2 * 3 + O * 6
    assert (got["00004.jpg"][2:9, 20:31] == 2).all()
    # object 2 is decoded after its join, not left at −1e9
    assert all((got[f"{i:05d}.jpg"] == 2).any() for i in range(5, 10))
