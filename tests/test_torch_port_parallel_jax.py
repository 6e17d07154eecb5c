"""The port's data-parallel training against the JAX package's, on the
CPU.

* Two gloo ranks of the port (``engine.dp_check.data_parallel_steps``,
  spawned by ``parallel.launch``) against JAX's ``Trainer`` with
  ``MESH_DATA_AXIS=2`` on two of ``tests/conftest.py``'s virtual
  devices, from the same weights (``convert_torch_statedict``), over the
  same two global batches of two items with the run's step keys, at the
  tiny setting of ``tests/test_torch_port_train_step.py`` (dropout 0:
  the two packages draw their masks apart).  The first step's per-frame
  losses within 1e-5 relative (the bar of that file's one-process
  comparison, from the same weights); the second step's within 1e-4:
  by then each side has applied its own first update, from gradients
  that part by up to 2e-2 of a tensor's scale (``engine.grad_check``:
  a rounding-sized change of this random network's weights moves its
  gradients by percents), and the losses part by 4.1e-5.
* ``TrainBatcher`` with ``process_index``/``process_count`` against
  JAX's for 2 and 4 processes: every array of every slice equal, and an
  epoch entered mid-way (the port's resume) equal to the rest of JAX's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from rvos_tpu.configs import tiny_test as j_tiny
from rvos_tpu.data import datasets as jds
from rvos_tpu.data.loader import TrainBatcher as JBatcher

from rvos_tpu_torch.cli import train as tcli
from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import datasets as tds
from rvos_tpu_torch.data.loader import TrainBatcher
from rvos_tpu_torch.engine.dp_check import data_parallel_steps
from rvos_tpu_torch.engine.train import Trainer
from rvos_tpu_torch.parallel.launch import launch
from torch_port_cases import (TRAIN_KW, assert_same, jax_params,
                              jax_transform, train_batch)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

JKW = dict(TRAIN_KW, TRAIN_BATCH_SIZE=2, MESH_DATA_AXIS=2)


def test_two_ranks_losses_match_jax_trainer():
    if len(jax.devices()) < 2:
        pytest.skip("needs conftest's virtual devices")
    from rvos_tpu.engine.train import Trainer as JTrainer

    cfg = tiny_test(**JKW)
    init = Trainer(cfg, device="cpu", seed=0).model.state_dict()
    batches = [train_batch(s, b=2) for s in range(2)]
    ranks = launch(data_parallel_steps, 2, "gloo", ["cpu"] * 2,
                   (cfg, init, batches, 0, 0), threads=1)

    jtr = JTrainer(j_tiny(**JKW))
    assert jtr.mesh.shape["data"] == 2
    # the state replicated on the mesh, as the step returns it: the second
    # step then reuses the first one's program (fed the single-device
    # state, the first step's program is compiled a second time; the
    # losses are the same bit for bit either way)
    jtr.state = jax.device_put(jtr.state._replace(params=jax_params(init)),
                               NamedSharding(jtr.mesh, PartitionSpec()))
    rng = jax.random.PRNGKey(1234)
    for s, batch in enumerate(batches):
        rng, sub = jax.random.split(rng)
        m = jtr.train_step(batch, sub)
        want = np.asarray(m["seq_losses"])
        for r in ranks:
            got = r["steps"][s]["seq_losses"].numpy()
            rel = np.abs(got - want) / np.abs(want)
            assert rel.max() <= (1e-5, 1e-4)[s], (s, got, want)


@pytest.mark.parametrize("count", [2, 4])
def test_process_slices_match_jax(count):
    """17 synthetic clips, a global batch of 4: four batches an epoch (the
    17th clip dropped), each process's slice of each."""
    jset = jds.SyntheticTrain(size=(33, 33), curr_len=2, length=17)
    tset = tds.SyntheticTrain(size=(33, 33), curr_len=2, length=17)
    cfg, jcfg = tiny_test(DATA_CURR_SEQ_LEN=2), j_tiny(DATA_CURR_SEQ_LEN=2)
    for index in range(count):
        jb = JBatcher(jset, 4, jax_transform(jcfg, True), seed=3,
                      num_workers=2, process_index=index,
                      process_count=count)
        tb = TrainBatcher(tset, 4, tcli.train_transform(cfg, True), seed=3,
                          num_workers=2, process_index=index,
                          process_count=count)
        for epoch in (0, 1):
            want = list(jb.epoch(epoch))
            got = list(tb.epoch(epoch))
            assert len(got) == len(want) == 4
            assert got[0]["curr_img"].shape[:2] == (2, 4 // count)
            assert_same(got, want, f"process {index} epoch {epoch}")
        assert_same(list(tb.epoch(1, start=2)), want[2:],
                    f"process {index}, epoch 1 from its third batch")


def test_indivisible_global_batch_raises():
    tset = tds.SyntheticTrain(size=(33, 33), curr_len=2, length=5)
    with pytest.raises(ValueError, match="not divisible"):
        TrainBatcher(tset, 3, lambda s: s, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="not divisible"):
        JBatcher(tset, 3, lambda s: s, process_index=0, process_count=2)
    assert torch.get_num_threads() == 2
