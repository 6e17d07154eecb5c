"""The port's sharded multi-scale + flip ensemble against the JAX
evaluator's, on the CPU.

The JAX evaluator shards its ensemble over ``tests/conftest.py``'s 8
virtual CPU devices when ``TEST_ENSEMBLE_SHARD`` is set; the test takes
the first ``n`` (as ``tests/test_ensemble_shard.py`` does).  The port's
evaluator gets ``devices=[cpu] * n``: the same partitions, replicas and
pinned states, on one device.  ``n = 4`` gives a variant per device (a
flip twin embeds its frame alone), ``n = 2`` a scale group per device.
The setting is ``MF_KW`` of ``tests/torch_port_cases.py`` (scales 1.0
and 1.3 with flip: four variants, 33×33 and 49×49 frames; the 0.8 of
``tests/test_ensemble_shard.py`` snaps back to 33×33 and would hide a
mix-up of scales), held by the unsharded ensemble's gates: masks on
≥ 99.9 % of every frame, each variant's state equal."""

import types

import jax
import numpy as np
import pytest
import torch

from rvos_tpu.configs import tiny_test
from rvos_tpu.data.datasets import SyntheticEval
from rvos_tpu.engine.eval import Evaluator

from rvos_tpu_torch import configs as tconfigs
from rvos_tpu_torch.data import SyntheticEval as TSyntheticEval
from rvos_tpu_torch.data.transforms import variant_list
from rvos_tpu_torch.engine import Evaluator as TEvaluator
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.weights import init_random_
from torch_port_cases import (MF_KW, SIZE, assert_masks_agree,
                              assert_states_equal, jax_init,
                              port_model_from_jax)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
SHARD_KW = dict(MF_KW, TEST_ENSEMBLE_SHARD=True)


def _variants(scales):
    return [{"scale": s, "flip": f} for s, f in variant_list(True, scales)]


@pytest.mark.parametrize("scales", [(1.0, 1.3), (1.0, 1.15, 1.3)])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_partitions_match_jax(scales, n_dev):
    """Variant → device for 4 and 6 variants over 2, 4 and 8 devices:
    both granularities (4 variants: groups over 2, variants over 4 and 8;
    6 variants: groups over 2 and 4, variants over 8)."""
    cfg = tconfigs.tiny_test(**dict(SHARD_KW, TEST_MULTISCALE=scales))
    ev = TEvaluator(cfg, TAOCNet(cfg), device="cpu",
                    devices=[torch.device("cuda", i) for i in range(n_dev)])
    got = [(list(mem), [d.index] * len(mem))
           for mem, _, d in ev._ens_partitions()]
    jdevs = list(range(n_dev))
    want = Evaluator._ens_partitions(types.SimpleNamespace(ens_devices=jdevs),
                                     _variants(scales))
    assert got == [([i for i, _ in mem], [d] * len(mem))
                   for mem, _, d in want]
    assert ev.chunk_n == 1


@pytest.fixture(scope="module")
def variables(tmp_path_factory):
    """The JAX model's own weights at ``MF_KW``, made once a run (the
    unsharded ensemble's file asks for the same)."""
    return jax_init(tmp_path_factory, "mf_init", MF_KW)


@pytest.mark.parametrize("n_dev", [4, 2])
def test_sharded_ensemble_matches_jax(variables, n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("needs conftest's virtual devices")
    from rvos_tpu.models.aocnet import AOCNet

    cfg = tiny_test(**SHARD_KW)
    jev = Evaluator(cfg, AOCNet(cfg), variables)
    assert jev.ens_devices is not None, "conftest provides 8 devices"
    jev.ens_devices = jev.ens_devices[:n_dev]
    want = jev.evaluate_sequence(SyntheticEval(size=SIZE, n_seqs=1,
                                               n_frames=6)[0])["results"]
    jstates = jev._last_states
    assert len({st.device for st in jstates}) == n_dev
    tcfg = tconfigs.tiny_test(**SHARD_KW)
    ev = TEvaluator(tcfg, port_model_from_jax(tcfg, variables), device="cpu",
                    devices=[CPU] * n_dev)
    got = ev.evaluate_sequence(TSyntheticEval(size=SIZE, n_seqs=1,
                                              n_frames=6)[0])
    assert ev.ens_devices == [CPU] * n_dev and ev.chunk_n == 1
    assert_masks_agree(want, got["results"])
    assert_states_equal(jstates, ev._last_states)


def test_single_variant_never_shards():
    """One variant with four devices: no sharding, the chunked graph
    path's settings kept, masks equal to the one-device run's."""
    kw = dict(SHARD_KW, TEST_FLIP=False, TEST_MULTISCALE=(1.0,),
              TEST_FRAME_CHUNK=2)
    cfg = tconfigs.tiny_test(**kw)
    runs = []
    for devices in (None, [CPU] * 4):
        model = init_random_(TAOCNet(cfg), torch.Generator().manual_seed(0))
        ev = TEvaluator(cfg, model, device="cpu", devices=devices)
        assert ev.ens_devices is None and ev.chunk_n == 2
        runs.append(ev.evaluate_sequence(TSyntheticEval(
            size=SIZE, n_seqs=1, n_frames=5)[0])["results"])
    for k in runs[0]:
        np.testing.assert_array_equal(runs[1][k], runs[0][k])


def test_context_parallel_disables_sharding():
    cfg = tconfigs.tiny_test(**dict(SHARD_KW, MESH_MODEL_AXIS=2))
    ev = TEvaluator(cfg, TAOCNet(cfg), device="cpu", devices=[CPU] * 4)
    assert ev.cp_devices == [CPU, CPU]
    assert ev.ens_devices is None
    deg = TEvaluator(cfg, TAOCNet(cfg), device="cpu")
    assert deg.cp_devices is None and deg.ens_devices is None
