"""The output check's power: a run with the timed path broken underneath
(the harness's look for a chip skipped: the port's evaluator on the CPU,
at the tiny cell's sizes) must come out not correct, one fault at a
time; and the control, the reference computed in fp8, must fail the
cell's limits where the float32 reference passes.  One chip, so no
exchange between chips can be left out."""

import pytest
import torch

from benchmark.drivers import eval_videos
from benchmark.harness.manifest import ROOT, load_json
from benchmark.reference.aocnet import fp8_cast
from benchmark.tests.tiny import passes, tiny_cell

SEED = 2 ** 35 + 11
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _state_unchanged(step):
    """Each step puts back the state it advanced (previous frame,
    previous mask, decoder memory)."""
    def run(self, io, sts, ori_hw, join=None):
        saved = [[t.clone() for t in st.carried()] for st in sts]
        step(self, io, sts, ori_hw, join)
        for st, ts in zip(sts, saved):
            for dst, src in zip(st.carried(), ts):
                dst.copy_(src)
    return run


def _half_batch(step):
    """A chunk's later half gets the earlier half's last mask."""
    def run(self, io, sts, ori_hw, join=None):
        step(self, io, sts, ori_hw, join)
        k = io.preds.shape[0]
        if k > 1:
            io.preds[k // 2:] = io.preds[k // 2 - 1]
    return run


def _altered_answer(step):
    """Every mask's upper left quarter moves to the next label."""
    def run(self, io, sts, ori_hw, join=None):
        step(self, io, sts, ori_hw, join)
        h, w = io.preds.shape[1:]
        q = io.preds[:, :h // 2, :w // 2]
        q.copy_((q + 1) % 2)
    return run


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


def _run(cell, control_cast=None):
    return eval_videos.run(cell, SEED, 1e9, False, device="cpu",
                           videos_limit=2, max_videos=2,
                           control_cast=control_cast)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("limits_of", CELLS)
def test_fault_fails_the_check(monkeypatch, fault, limits_of):
    from rvos_tpu_torch.engine import Evaluator
    cell = tiny_cell(limits_of=limits_of)
    monkeypatch.setattr(Evaluator, "chunk_step",
                        FAULTS[fault](Evaluator.chunk_step))
    res = _run(cell)
    assert not passes(res["check"], cell.limits), res["check"]


@pytest.mark.parametrize("limits_of", CELLS)
def test_control_fails_where_the_reference_passes(limits_of):
    cell = tiny_cell(limits_of=limits_of)
    res = _run(cell, control_cast=fp8_cast)
    assert passes(res["check"], cell.limits), res["check"]
    assert not passes(res["control"], cell.limits), res["control"]
