"""The port's streaming pipeline on the CPU: the ``Chunker`` cuts against
the JAX package's, the batched mask copies and the mask writer, the
prefetch loader, and the chunked evaluator against its own frame-by-frame
run (``TEST_FRAME_CHUNK=3``, ``MEM_EVERY=3``) on a video whose objects
change mid-chunk and which splices a mid-video label."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from rvos_tpu.engine.eval_pipeline import Chunker as JChunker

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import PrefetchLoader, SyntheticEval
from rvos_tpu_torch.engine import Evaluator
from rvos_tpu_torch.engine.eval_pipeline import Chunker, D2HBatcher, MaskSaver
from rvos_tpu_torch.engine.lockstep import (lockstep_chunks, parity_config,
                                            parity_scores)
from rvos_tpu_torch.models import AOCNet
from rvos_tpu_torch.weights import init_random_
from torch_port_threads import torch_threads  # noqa: F401 (autouse)


def _cuts(chunker_cls, chunk_n, mem_every, pushes):
    """Drive a Chunker with ``pushes`` (frame, sig, ov, em, hw) → the
    list of (kind, frames) it dispatched."""
    calls = []
    ch = chunker_cls(
        chunk_n, lambda buf, ctx: calls.append(("full", [b[0] for b in buf])),
        lambda buf, ctx: calls.append(("ragged", [b[0] for b in buf])),
        lambda f: mem_every > 0 and f % mem_every == 0)
    for f, sig, ov, em, hw in pushes:
        ch.push(f, f"{f:05d}.jpg", f, sig, np.array(ov, np.float32),
                np.array(em, np.float32), hw)
    ch.flush()
    return calls


def _pushes(n, changes):
    """Frames 1..n with the context ``changes`` {frame: field → value}
    applied from that frame on."""
    ctx = dict(sig=(33, 33), ov=(1, 1, 0), em=(1, 1, 0), hw=(33, 33))
    out = []
    for f in range(1, n + 1):
        ctx.update(changes.get(f, {}))
        out.append((f, ctx["sig"], ctx["ov"], ctx["em"], ctx["hw"]))
    return out


_SCENARIOS = {
    "chunk_size": (3, 0, _pushes(10, {})),
    "mem_every": (4, 5, _pushes(16, {})),
    "chunk_capped_by_mem": (5, 3, _pushes(13, {})),
    "shape_signature": (3, 0, _pushes(9, {5: {"sig": (49, 65)}})),
    "ori_hw": (3, 0, _pushes(9, {2: {"hw": (40, 40)}})),
    "obj_valid": (3, 5, _pushes(12, {7: {"ov": (1, 1, 1)}})),
    "exist_mask": (3, 5, _pushes(12, {8: {"em": (1, 1, 1)}})),
    "ragged_tail": (4, 0, _pushes(6, {})),
    "frame_by_frame": (1, 5, _pushes(7, {3: {"em": (1, 0, 0)}})),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_chunker_cuts_like_jax(name):
    """The same push sequence gives the JAX package's cuts: at the chunk
    size, right after a MEM_EVERY frame, on each context change, and a
    ragged tail."""
    chunk_n, mem_every, pushes = _SCENARIOS[name]
    want = _cuts(JChunker, chunk_n, mem_every, pushes)
    got = _cuts(Chunker, chunk_n, mem_every, pushes)
    assert got == want
    assert [f for _, fs in got for f in fs] == [p[0] for p in pushes]


def test_d2h_batcher_groups_by_resolution(tmp_path):
    """Blocks go down as they are, single frames concatenated per
    resolution at the flush; every mask comes back and is written."""
    saver = MaskSaver(str(tmp_path))
    d2h = D2HBatcher(saver, group=5)
    a = torch.arange(2 * 4 * 4, dtype=torch.uint8).reshape(2, 4, 4)
    d2h.append(("a0.jpg", "a1.jpg"), a)
    d2h.append(("b0.jpg",), torch.full((1, 4, 4), 7, dtype=torch.uint8))
    d2h.append(("c0.jpg",), torch.full((1, 8, 8), 9, dtype=torch.uint8))
    d2h.maybe_flush()
    assert d2h.frames() == 4             # below the group: kept
    d2h.append(("b1.jpg",), torch.full((1, 4, 4), 8, dtype=torch.uint8))
    assert d2h.frames() == 5
    d2h.maybe_flush()
    assert d2h.frames() == 0
    out = saver.drain()
    assert set(out) == {"a0.jpg", "a1.jpg", "b0.jpg", "c0.jpg", "b1.jpg"}
    np.testing.assert_array_equal(out["a1.jpg"], a[1].numpy())
    assert out["c0.jpg"].shape == (8, 8) and (out["c0.jpg"] == 9).all()
    assert (out["b0.jpg"] == 7).all() and (out["b1.jpg"] == 8).all()
    assert sorted(os.listdir(tmp_path)) == [
        "a0.png", "a1.png", "b0.png", "b1.png", "c0.png"]


def test_mask_saver_restores_raw_ids(tmp_path):
    """The ``label_backward`` LUT maps model channels back to the raw
    ids in the returned masks and the PNGs; 255 stays."""
    lut = np.arange(256, dtype=np.uint8)
    lut[1], lut[2] = 1, 13
    saver = MaskSaver(str(tmp_path), remap=lut)
    block = torch.tensor([[[0, 1], [2, 255]], [[2, 2], [1, 0]]],
                         dtype=torch.uint8)
    saver.submit_blocks([(("x.jpg", "y.jpg"), block, None)])
    out = saver.drain()
    want = np.array([[[0, 1], [13, 255]], [[13, 13], [1, 0]]], np.uint8)
    np.testing.assert_array_equal(out["x.jpg"], want[0])
    np.testing.assert_array_equal(out["y.jpg"], want[1])
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "y.png")), want[1])


class _Slow:
    """Items that finish out of order; one index may raise."""

    def __init__(self, n, fail=None):
        self.n, self.fail = n, fail
        self.threads = set()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.threads.add(threading.get_ident())
        time.sleep(0.002 * ((7 * i) % 5))
        if i == self.fail:
            raise KeyError(f"frame {i}")
        return i


class _Fast:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_loader_keeps_order(workers):
    ds = _Slow(23)
    assert list(PrefetchLoader(ds, num_workers=workers, prefetch=4)) == \
        list(range(23))
    assert len(ds.threads) <= workers


def test_prefetch_loader_under_thread_switching():
    """More threads than cores, switching every microsecond: every item
    comes out once, in order, however the workers interleave."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n = 200
        got = list(PrefetchLoader(_Fast(n), num_workers=4 * (os.cpu_count()
                                                             or 1) + 2,
                                  prefetch=7))
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(n))


def test_prefetch_loader_raises_a_worker_error_in_order():
    got = []
    with pytest.raises(KeyError, match="frame 5"):
        for x in PrefetchLoader(_Slow(12, fail=5), num_workers=3, prefetch=3):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


SIZE = (33, 33)
_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
           MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None, TEST_BANK_CAPACITY=3,
           MEM_EVERY=3)


class _Changing:
    """A 13-frame synthetic video, obj_num 3, with only object 1 annotated
    on frame 0: object 3 is spliced in on frame 4 (a join frame), and
    object 2 appears in ``current_label_all`` from frame 8 on, so
    ``exist_mask`` changes inside the chunk of frames 7-9."""

    def __init__(self):
        self.seq = SyntheticEval(size=SIZE, n_seqs=1, n_frames=13)[0]
        self.seq_name = "changing"

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        s = self.seq[idx]
        s["meta"]["obj_num"] = 3
        if idx == 0:
            s["current_label"][s["current_label"] == 2] = 0
        if idx == 4:
            lab = np.zeros(SIZE, np.uint8)
            lab[2:9, 20:31] = 3
            s["current_label"] = lab
        if idx >= 8:
            lab = np.zeros(SIZE, np.uint8)
            lab[20:28, 4:12] = 2
            s["current_label_all"] = lab
        return s


@pytest.fixture(scope="module")
def chunked_vs_frames():
    out, steps = {}, {}
    for chunk in (1, 3):
        cfg = tiny_test(TEST_FRAME_CHUNK=chunk, **_KW)
        ev = Evaluator(cfg, init_random_(AOCNet(cfg),
                                         torch.Generator().manual_seed(1)),
                       device="cpu")
        run = ev.run_chunk
        steps[chunk] = []

        def spy(sts, io, ori_hw, join=None, _run=run, _steps=steps[chunk]):
            _steps.append(io.frames[0].shape[0])
            return _run(sts, io, ori_hw, join)

        ev.run_chunk = spy
        out[chunk] = ev.evaluate_sequence(_Changing())
    return out, steps


def test_chunked_evaluator_matches_frame_by_frame(chunked_vs_frames):
    """Under 0.5 % of the video's pixels differ (the bar of the JAX
    suite's ``test_chunk_cut_on_exist_mask_change``; a batch of 3 frames
    through the backbone rounds differently from one)."""
    out, _ = chunked_vs_frames
    a, b = out[1]["results"], out[3]["results"]
    assert sorted(a) == sorted(b) == [f"{i:05d}.jpg" for i in range(1, 13)]
    diff = sum(int((a[k] != b[k]).sum()) for k in a)
    total = sum(m.size for m in a.values())
    assert diff / total < 0.005, diff / total
    for res in (a, b):
        assert (res["00004.jpg"][2:9, 20:31] == 3).all()   # the join splices
        assert set(np.unique(np.concatenate([m.ravel() for m in res.values()]))
                   ) <= {0, 1, 2, 3}


def test_chunked_evaluator_cuts_where_jax_does(chunked_vs_frames):
    """Frames 1-3 and 10-12 run as chunks; the join frame 4, the frames
    5-6 before the memory update, and 7 | 8-9 around the exist_mask change
    run one by one."""
    out, steps = chunked_vs_frames
    assert steps[1] == [1] * 12
    assert steps[3] == [3] + [1] * 6 + [3]
    for o in out.values():
        assert o["frames"] == 12
        assert set(o["timing"]) == {"loader_wait", "flat", "step_dispatch",
                                    "flush", "drain"}
        assert o["fps"] > 0


@pytest.mark.parametrize("knob", ["TEST_H2D_GROUP", "TEST_WORKERS",
                                  "TEST_D2H_GROUP"])
def test_pipeline_knobs_keep_the_masks(knob, chunked_vs_frames):
    """Grouped uploads, one loader thread, or one mask per copy give the
    chunked run's masks exactly."""
    out, _ = chunked_vs_frames
    value = {"TEST_H2D_GROUP": 4, "TEST_WORKERS": 1, "TEST_D2H_GROUP": 1}[knob]
    cfg = tiny_test(TEST_FRAME_CHUNK=3, **{**_KW, knob: value})
    ev = Evaluator(cfg, init_random_(AOCNet(cfg),
                                     torch.Generator().manual_seed(1)),
                   device="cpu")
    got = ev.evaluate_sequence(_Changing())["results"]
    for k, m in out[3]["results"].items():
        np.testing.assert_array_equal(got[k], m)


def test_chunk_lockstep_on_one_device_agrees_exactly():
    """The chunk lock-step harness against itself on the CPU: two chunks
    of 3 (the second after a bank update), every frame identical."""
    cfg = parity_config("occupancy", "mixed").replace(TEST_FRAME_CHUNK=3,
                                                      MEM_EVERY=3)
    res = lockstep_chunks(cfg, lambda: init_random_(
        AOCNet(cfg), torch.Generator().manual_seed(0)),
        SyntheticEval(size=(65, 65), n_seqs=1, n_frames=7)[0],
        parity_scores, device="cpu")
    assert res.steps == [3, 3] and res.replays == 0
    assert res.agree == [1.0] * 6
    assert res.max_dlogit == 0.0 and res.max_demb == 0.0


def test_chunk_agreement_cli_runs_on_cpu(capsys):
    """The diagnostic CLI at a tiny size on the CPU (float32 both ways):
    a line per compute mode, chunked and frame-by-frame masks within the
    0.5 % bar, batch-5 and batch-1 embeddings at float32 rounding."""
    from rvos_tpu_torch.cli import chunk_agreement
    chunk_agreement.main(["--config", "tiny_test", "--size", "33", "33",
                          "--frames", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["preset", "parity"]
    for ln in lines:
        agree = json.loads(ln.split("per frame ")[1].split(";")[0])
        assert len(agree) == 5 and np.mean(agree) >= 0.995
        assert float(ln.split("(")[-1].split()[0]) < 1e-4


def test_host_postprocess_path_matches_fused_frames(chunked_vs_frames):
    """``TEST_FUSED_POSTPROCESS=False`` (every frame alone, the host
    post-processing path) gives the fused frame-by-frame run's masks
    exactly: one frame at a time, both are the same step."""
    out, _ = chunked_vs_frames
    cfg = tiny_test(TEST_FUSED_POSTPROCESS=False, **_KW)
    ev = Evaluator(cfg, init_random_(AOCNet(cfg),
                                     torch.Generator().manual_seed(1)),
                   device="cpu")
    got = ev.evaluate_sequence(_Changing())["results"]
    assert ev.chunk_n == 1
    for k, m in out[1]["results"].items():
        np.testing.assert_array_equal(got[k], m)
