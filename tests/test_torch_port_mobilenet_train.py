"""The port's training step with the MobileNetV2 backbone
(``MODEL_BACKBONE="mobilenet"``) against the JAX package's, on the CPU
in float32: the port's seeded random weights carried to JAX with
``convert_torch_statedict`` and one jitted JAX ``value_and_grad`` of
``make_train_step(...).loss_fn``, at the step setting of
``tests/torch_port_cases.py``.  Held as ``test_torch_port_train_step.py``
holds the ResNet's: per-frame losses within 1e-5 relative, IoUs equal,
every gradient tensor within 2e-2 of its largest |g| or three times the
port's floor, and all gradients within 2e-2 relative L2."""

import numpy as np
import pytest

from torch_port_threads import torch_threads  # noqa: F401 (autouse)

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.engine.grad_check import gradient_failures
from rvos_tpu_torch.engine.train import Trainer
from rvos_tpu_torch.models.mobilenet import MobileNetV2
from torch_port_cases import TRAIN_KW, compare_with_jax

KW = dict(TRAIN_KW, MODEL_BACKBONE="mobilenet")


@pytest.fixture(scope="module")
def against_jax():
    return compare_with_jax(KW)


def test_train_step_losses_match_jax(against_jax):
    r = against_jax
    rel = np.abs(r["losses"] - r["jlosses"]) / np.abs(r["jlosses"])
    assert rel.max() <= 1e-5, (r["losses"], r["jlosses"])
    np.testing.assert_array_equal(r["ious"], r["jious"])


def test_train_step_gradients_match_jax(against_jax):
    r = against_jax
    assert any(n.startswith("feature_extracter.backbone.block_")
               for n in r["grads"])
    want = {n: r["jgrads"][n] for n in r["grads"]}
    bad, summary = gradient_failures(r["grads"], want, r["floor"], 2e-2)
    print(summary)
    assert not bad, bad
    assert summary["all_l2_rel"] <= 2e-2, summary


def test_trainer_builds_a_mobilenet():
    tr = Trainer(tiny_test(**KW), device="cpu", seed=0)
    assert isinstance(tr.model.feature_extracter.backbone, MobileNetV2)
