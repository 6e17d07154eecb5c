"""The port's training losses against the JAX package's, on the CPU:
``hard_mining_ce`` (with ignored pixels), ``hard_mining_bce`` and
``batched_iou``, across the hard-mining anneal of 10 steps: step 0
(k = 100 %, more than the valid pixels), steps 1, 5 and 7 (mid-anneal),
10 and 25 (k = 15 %).  Tolerance: 1e-6 relative (float32 sums in
another order); the mined pixel count is equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvos_tpu.engine import loss as jloss

from rvos_tpu_torch.engine import loss as tloss
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

O, H, W = 4, 31, 29
HMS = 10
STEPS = (0, 1, 5, 7, 10, 25)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((O, H, W))).astype(np.float32)
    labels = rng.integers(0, O, (H, W)).astype(np.int32)
    labels[:3] = 255
    labels[10, 4:9] = 255
    return logits, labels


@pytest.mark.parametrize("step", STEPS)
def test_hard_mining_ce_matches_jax(step):
    logits, labels = _inputs(step)
    want = float(jloss.hard_mining_ce(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(step), 0.15, HMS))
    got = float(tloss.hard_mining_ce(torch.from_numpy(logits),
                                     torch.from_numpy(labels), step, 0.15,
                                     HMS))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize("step", STEPS)
def test_hard_mining_bce_matches_jax(step):
    logits, labels = _inputs(100 + step)
    target = (labels[None] == np.arange(O)[:, None, None]).astype(np.float32)
    want = float(jloss.hard_mining_bce(jnp.asarray(logits),
                                       jnp.asarray(target), jnp.asarray(step),
                                       0.15, HMS))
    got = float(tloss.hard_mining_bce(torch.from_numpy(logits),
                                      torch.from_numpy(target), step, 0.15,
                                      HMS))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_mined_count_is_float32():
    """k in float32 as JAX computes it, at every step of a long anneal
    over a 465² crop, and at ``hard_mining_step`` 0."""
    n = 465 * 465
    for step in range(0, 50_001, 37):
        ratio = jnp.minimum(1.0, jnp.asarray(step).astype(jnp.float32)
                            / 50_000)
        want = int(jnp.maximum(jnp.floor((ratio * 0.15 + (1.0 - ratio)) * n),
                               1.0))
        assert tloss.mined_count(n, step, 0.15, 50_000) == want, step
    assert tloss.mined_count(n, 3, 0.15, 0) == int(0.15 * n)


def test_ce_gradient_matches_jax():
    """The gradient of the mined CE: only the selected pixels, over their
    count."""
    import jax
    logits, labels = _inputs(7)
    jg = np.asarray(jax.grad(lambda x: jloss.hard_mining_ce(
        x, jnp.asarray(labels), jnp.asarray(5), 0.15, HMS))(
            jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    tloss.hard_mining_ce(x, torch.from_numpy(labels), 5, 0.15, HMS).backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=1e-7)


@pytest.mark.parametrize("obj_num", [[2, 3], [0, 1], [3, 0]])
def test_batched_iou_matches_jax(obj_num):
    rng = np.random.default_rng(sum(obj_num))
    pred = rng.integers(0, O, (2, H, W)).astype(np.int32)
    target = pred.copy()
    target[:, :9] = rng.integers(0, O, (2, 9, W))
    n = np.asarray(obj_num, np.int32)
    want = float(jloss.batched_iou(jnp.asarray(pred), jnp.asarray(target),
                                   jnp.asarray(n), O))
    got = float(tloss.batched_iou(torch.from_numpy(pred),
                                  torch.from_numpy(target),
                                  torch.from_numpy(n), O))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (got, want)
