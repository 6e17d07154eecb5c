"""The port's ``--float16`` training step (``MATCHING_DTYPE="bfloat16"``:
float32 tower, bf16 matching operands) against the JAX package's, on the
CPU: the whole step as ``test_torch_port_train_step.py`` runs it (one
jitted JAX ``value_and_grad`` of ``make_train_step(...).loss_fn`` at
33×33, the port's seeded weights carried over, burn-in live, hard mining
mid-anneal), compared with the port's same step and with the port's
float32 step (``MATCHING_DTYPE="mixed"``) on the same weights.

Measured: losses 2.4e-5 and 3.7e-5 relative from JAX's, all gradients
3.3e-2 relative L2; the port's float32 step is 1.2e-4 to 3.5e-4 and 0.11
from it.  Bars (``engine.grad_check.BF16_BARS``): losses 8e-5, L2 6e-2 —
each below the float32 step's gap (asserted: the power check).  Each
parameter tensor within the route's bar of its scale or three times the
port's floor of the route (``engine.grad_check``, weights scaled by
1 + 1e-6·N(0, 1)).  The bf16-compute route has a file of its own (its
JAX program is another cold compile); the route's pieces are in
``test_torch_port_train_bf16.py``."""

import pytest

from torch_port_threads import torch_threads  # noqa: F401 (autouse)

from rvos_tpu_torch.engine.grad_check import BF16_BARS, gradient_failures
from torch_port_cases import compare_route_with_jax, jax_gaps

LOSS_BAR, L2_BAR, TENSOR_BAR = BF16_BARS["matching"]


@pytest.fixture(scope="module")
def against_jax():
    return compare_route_with_jax("matching")


def test_step_losses_match_jax(against_jax):
    r = against_jax
    rel, _ = jax_gaps(r, r["grads"], r["losses"])
    print("losses", r["losses"], "jax", r["jlosses"], "rel", rel)
    assert rel.max() <= LOSS_BAR, rel


def test_step_gradients_match_jax(against_jax):
    r = against_jax
    want = {n: r["jgrads"][n] for n in r["grads"]}
    bad, summary = gradient_failures(r["grads"], want, r["floor"], TENSOR_BAR)
    print(summary)
    assert not bad, bad
    assert summary["all_l2_rel"] <= L2_BAR, summary


def test_power_against_the_float32_step(against_jax):
    """The float32 step's gap from JAX's ``--float16`` step is beyond
    each bar."""
    r = against_jax
    f_rel, f_l2 = jax_gaps(r, r["f32_grads"], r["f32_losses"])
    rel, l2 = jax_gaps(r, r["grads"], r["losses"])
    print("float32 step: losses", f_rel, "L2", f_l2,
          "| bf16 step: losses", rel, "L2", l2)
    assert LOSS_BAR < f_rel.min(), f_rel
    assert L2_BAR < f_l2, f_l2
