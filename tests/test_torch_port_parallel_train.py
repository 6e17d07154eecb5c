"""Data-parallel and context-parallel training of the port on the CPU.

Two gloo processes spawned by the port's launcher
(``parallel.launch.launch``: one
torch thread each, an OS-picked rendezvous port, a join timeout of its
own), at the step setting of ``tests/torch_port_cases.py``
with the ASPP dropout on (0.2) and remat, a global batch of two items:

* against the single process's per-item average
  (``engine.dp_check.per_item_steps``, one thread): the loss, the
  per-frame losses, every gradient the optimizer reads and the
  parameters after each of two steps, bit for bit (the two ranks'
  gradients meet by one addition and one division, the reference's);
* against the single process at batch 2 (one step): every gradient
  within ``engine.grad_check``'s bar (2e-2 of the tensor's scale or
  three times the batch-2 run's own ten-ulp floor) and all of them
  within 2e-2 relative L2 — batch-2 and batch-1 convolutions round
  apart, and the network's gradients are chaotic under rounding;
* ``Trainer.fit`` on two ranks: rank 0 alone writes the log and the
  checkpoint, and a two-rank run resumed from its checkpoint ends where
  an uninterrupted one does (step, data position, update count,
  parameters bit for bit).

Context parallelism in training (``MESH_MODEL_AXIS=2`` over
``[cpu] * 2``): ``GlobalMatchingMin`` on two query-row shards against
the unsharded step, within the bars of a comparison with JAX."""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_threads import torch_threads  # noqa: F401 (autouse)

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.engine.dp_check import (batch_slice, data_parallel_steps,
                                            fit_steps, per_item_steps)
from rvos_tpu_torch.engine.grad_check import (floors, gradient_failures,
                                              perturbed_state)
from rvos_tpu_torch.engine.train import Trainer, batch_to_device
from rvos_tpu_torch.ops import prng
from rvos_tpu_torch.parallel.distributed import process_batch_slice
from rvos_tpu_torch.parallel.launch import launch
from torch_port_cases import TRAIN_KW, train_batch

DP_KW = dict(TRAIN_KW, MODEL_ASPP_DROPOUT=0.2, TRAIN_REMAT=True)
STEPS = 2


def run_ranks(fn, args):
    """``fn`` on two gloo ranks on the CPU, one torch thread each."""
    return launch(fn, 2, "gloo", ["cpu"] * 2, args, threads=1)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks():
    """Two ranks and the per-item reference over two global batches."""
    cfg = tiny_test(**DP_KW)
    init = Trainer(cfg, device="cpu", seed=3).model.state_dict()
    batches = [train_batch(s, b=2) for s in range(STEPS)]
    ranks = run_ranks(data_parallel_steps, (cfg, init, batches, 0))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = per_item_steps(cfg, init, batches, 0)
    finally:
        torch.set_num_threads(n)
    return cfg, init, batches, ranks, ref


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_equal_the_per_item_average(two_ranks, step):
    _, _, _, ranks, ref = two_ranks
    want = ref["steps"][step]
    for r in ranks:
        got = r["steps"][step]
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["seq_losses"], want["seq_losses"])
        assert torch.equal(got["grad_norm"], want["grad_norm"])
        assert got["applied"] is True
        assert got["reduce_bytes"] == 4 * sum(g.numel() for g in
                                              want["grads"].values())
        bad = [n for n, g in want["grads"].items()
               if not torch.equal(got["grads"][n], g)]
        assert not bad, bad
    local = [r["steps"][step]["local_grads"] for r in ranks]
    assert all(torch.equal(ranks[0]["steps"][step]["grads"][n],
                           (local[0][n] + local[1][n]) / 2) for n in local[0])


def test_two_ranks_end_with_the_reference_parameters(two_ranks):
    _, _, _, ranks, ref = two_ranks
    for r in ranks:
        bad = [n for n, p in ref["params"].items()
               if not torch.equal(r["steps"][-1]["params"][n], p)]
        assert not bad, bad


def test_two_ranks_against_one_process_at_batch_two(two_ranks, one_thread):
    """One step of the single process on the whole batch; its gradient's
    floor from three runs with the weights ten ulps apart."""
    cfg, init, batches, ranks, _ = two_ranks
    tr = Trainer(cfg, device="cpu", init_state=init, seed=0)
    key = prng.next_step_key(tr.run_key)[1]
    seeds = tr.draw_seeds()
    batch = batch_to_device(batches[0], torch.device("cpu"))

    def grads_at(state):
        tr.model.load_state_dict(state)
        tr.optimizer.zero_grad()
        loss, _ = tr._step_fn.loss_fn(batch, 0, key, seeds)
        loss.backward()
        return loss.detach(), {n: (p.grad.clone() if p.grad is not None
                                   else torch.zeros_like(p))
                               for n, p in tr.model.named_parameters()}

    loss, want = grads_at(init)
    names = list(want)
    runs = [grads_at(perturbed_state(init, names, s))[1] for s in range(3)]
    got = ranks[0]["steps"][0]
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    bad, summary = gradient_failures(got["grads"], want, floors(want, runs),
                                     2e-2)
    print(summary)
    assert not bad, bad
    assert summary["all_l2_rel"] <= 2e-2, summary


def test_fit_on_two_ranks_writes_once_and_resumes(tmp_path):
    """fit(3) on two ranks against fit(2) with a checkpoint at step 2,
    then a new two-rank run that resumes from it to step 3."""
    base = dict(DP_KW, TRAIN_TOTAL_STEPS=3, TRAIN_START_SEQ_TRAINING_STEPS=1,
                TRAIN_HARD_MINING_STEP=2, TRAIN_AUTO_RESUME=True,
                TRAIN_BATCH_SIZE=2)
    whole = tiny_test(**base, DIR_ROOT=str(tmp_path / "whole"))
    w = run_ranks(fit_steps, (whole, 3))
    cut = tiny_test(**base, DIR_ROOT=str(tmp_path / "cut"))
    first = run_ranks(fit_steps, (cut, 2, 0, 2))
    ckpt = cut.result_dirs()["ckpt"]
    assert sorted(os.listdir(ckpt)) == ["save_step_2.pth"]
    assert [r["step"] for r in first] == [2, 2]
    log = os.path.join(cut.result_dirs()["log"], "metrics.jsonl")
    assert [json.loads(x)["step"] for x in open(log)] == [1, 2]
    resumed = run_ranks(fit_steps, (cut, 3))
    for r, ref in zip(resumed, w):
        assert r["start"] == 2
        assert (r["step"], tuple(r["data_pos"]), r["count"]) == (
            3, tuple(ref["data_pos"]), 3)
        bad = [n for n, p in ref["params"].items()
               if not torch.equal(r["params"][n], p)]
        assert not bad, bad
    assert [json.loads(x)["step"] for x in open(log)] == [1, 2, 3]


def test_batch_slices_and_indivisible_batches():
    batch = train_batch(0, b=4)
    sl = batch_slice(batch, *process_batch_slice(4, 1, 2))
    assert sl["curr_img"].shape[:2] == (2, 2)
    np.testing.assert_array_equal(sl["ref_label"], batch["ref_label"][2:])
    np.testing.assert_array_equal(sl["curr_label"],
                                  batch["curr_label"][:, 2:])
    assert process_batch_slice(6, 2, 3) == (4, 2)
    with pytest.raises(ValueError, match="not divisible"):
        process_batch_slice(3, 0, 2)


def test_dropout_masks_are_the_global_batch_slices(one_thread):
    """Item 1 of a batch-2 forward gets the masks the global batch gives
    it: its loss alone with ``part=(1, 2)`` equals its share of the
    batch-2 loss's per-frame mean (the same draws), and differs from a
    batch-1 forward's (another mask)."""
    cfg = tiny_test(**dict(DP_KW, MODEL_ASPP_DROPOUT=0.5))
    tr = Trainer(cfg, device="cpu", seed=1)
    key = prng.next_step_key(tr.run_key)[1]
    batch = train_batch(4, b=2)
    cpu = torch.device("cpu")
    with torch.no_grad():
        items = [tr._step_fn.loss_fn(
            batch_to_device(batch_slice(batch, b, 1), cpu), 0, key,
            [5, 6, 7], (b, 2))[0] for b in range(2)]
        alone = tr._step_fn.loss_fn(
            batch_to_device(batch_slice(batch, 1, 1), cpu), 0, key,
            [5, 6, 7])[0]
        both = tr._step_fn.loss_fn(batch_to_device(batch, cpu), 0, key,
                                   [5, 6, 7])[0]
    torch.testing.assert_close((items[0] + items[1]) / 2, both, rtol=1e-5,
                               atol=0)
    assert abs(float(alone) - float(items[1])) > 1e-3 * float(alone)


def test_context_parallel_training_matches_unsharded(one_thread):
    """``MESH_MODEL_AXIS=2`` over ``[cpu] * 2``: the trainer splits its
    ``GlobalMatchingMin``, cluster and proxy rows, and the bank's
    gradient sums the shards'.  The CPU's matmul rounds a 41-row shard
    apart from the 81-row whole (1.5e-5 in a distance), so the per-frame
    losses are held to 1e-5 relative (the bar against JAX) and the
    gradients to ``engine.grad_check``'s (2e-2 of each tensor's scale or
    three times the unsharded run's ten-ulp floor; 2e-2 relative L2)."""
    batch = batch_to_device(train_batch(1, b=2), torch.device("cpu"))

    def run(tr, state=None):
        if state is not None:
            tr.model.load_state_dict(state)
        tr.optimizer.zero_grad()
        key = prng.next_step_key(prng.prng_key(prng.TRAIN_SEED))[1]
        loss, (losses, _, _) = tr._step_fn.loss_fn(batch, 5, key)
        loss.backward()
        return losses.detach(), {n: (p.grad.clone() if p.grad is not None
                                     else torch.zeros_like(p))
                                 for n, p in tr.model.named_parameters()}

    plain = Trainer(tiny_test(**TRAIN_KW), device="cpu", seed=4)
    sharded = Trainer(tiny_test(**dict(TRAIN_KW, MESH_MODEL_AXIS=2)),
                      device="cpu", seed=4, devices=["cpu", "cpu"])
    assert plain.cp_devices is None
    assert sharded.cp_devices == [torch.device("cpu")] * 2
    want_l, want = run(plain)
    got_l, got = run(sharded)
    torch.testing.assert_close(got_l, want_l, rtol=1e-5, atol=0)
    state = {k: v.clone() for k, v in plain.model.state_dict().items()}
    runs = [run(plain, perturbed_state(state, list(want), s))[1]
            for s in range(3)]
    bad, summary = gradient_failures(got, want, floors(want, runs), 2e-2)
    print(summary)
    assert not bad, bad
    assert summary["all_l2_rel"] <= 2e-2, summary
