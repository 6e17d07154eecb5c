"""The training route's differentiable matching against the JAX
package's, on the CPU.

* ``GlobalMatchingMin`` against ``global_matching_min`` (the custom VJP
  training differentiates) over a bank of two 4096-row tiles, the last
  one padded: forward and ``jax.grad`` with respect to the query and
  the bank.
* ``LocalMatchingMin`` against ``_local_matching_online_stacked`` (the
  XLA scan), raw; and through ``local_matching_bank_stacked`` (2×
  downsample, squash, upsample) against JAX's XLA path: forward and
  ``jax.grad`` with respect to the query, both previous frames and the
  distance bias.
* ``torch.autograd.gradcheck`` of both Functions in float64.

Inputs are random normal embeddings and one-hot labels from a seed, so
no two real distances tie.  Tolerance: 1e-5 of each output's or
gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvos_tpu.ops import matching as jm

from rvos_tpu_torch.ops.matching import local_matching_bank_stacked
from rvos_tpu_torch.ops.train_matching import (global_matching_min,
                                               local_min_argmin,
                                               local_matching_min)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)


def _close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of {scale:.3e}"


def _onehot(rng, shape, o, empty=0.0):
    lab = rng.integers(0, o, shape)
    oh = (lab[..., None] == np.arange(o)).astype(np.float32)
    if empty:
        oh[rng.random(shape) < empty] = 0.0
    return oh


def test_global_matching_min_matches_jax():
    rng = np.random.default_rng(0)
    m, r, c, o = 150, 4096 + 333, 12, 4
    q = rng.standard_normal((m, c)).astype(np.float32)
    bank = rng.standard_normal((r, c)).astype(np.float32)
    lab = _onehot(rng, (r,), o, empty=0.1)
    w = rng.standard_normal((m, o)).astype(np.float32)

    def jloss(q_, b_):
        return jnp.sum(jm.global_matching_min(q_, b_, jnp.asarray(lab))
                       * jnp.asarray(w))

    want = np.asarray(jm.global_matching_min(jnp.asarray(q), jnp.asarray(bank),
                                             jnp.asarray(lab)))
    jgq, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q),
                                               jnp.asarray(bank))
    tq = torch.from_numpy(q).requires_grad_()
    tb = torch.from_numpy(bank).requires_grad_()
    got = global_matching_min(tq, tb, torch.from_numpy(lab))
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach(), want, what="forward")
    _close(tq.grad, jgq, what="d query")
    _close(tb.grad, jgb, what="d bank")


@pytest.mark.parametrize("radii,atrous", [((1, 2), 1), ((2, 4), 2),
                                          ((1, 3, 4), 1)])
def test_local_min_matches_xla_scan(radii, atrous):
    rng = np.random.default_rng(sum(radii))
    h, w, c, o, s = 11, 13, 6, 3, 2
    x = rng.standard_normal((h, w, c)).astype(np.float32)
    ys = rng.standard_normal((s, h, w, c)).astype(np.float32)
    lab = _onehot(rng, (h, w), o)
    max_d = radii[-1]
    pad_d = max_d - max_d % atrous
    a_max = pad_d // atrous
    want = jm._local_matching_online_stacked(
        jnp.asarray(x), jnp.asarray(ys), jnp.asarray(lab),
        tuple(r // atrous for r in radii), a_max, 2 * a_max + 1, atrous,
        pad_d)
    got, _ = local_min_argmin(torch.from_numpy(x), torch.from_numpy(ys),
                              torch.from_numpy(lab), radii, atrous)
    _close(got, want, what="raw local mins")


@pytest.mark.parametrize("radii,atrous", [((1, 2), 1), ((2, 4), 2)])
def test_local_matching_gradients_match_jax(radii, atrous):
    rng = np.random.default_rng(7 + atrous)
    hh, ww, c, o, s = 17, 15, 8, 3, 2
    q = rng.standard_normal((hh, ww, c)).astype(np.float32)
    prev = rng.standard_normal((s, hh, ww, c)).astype(np.float32)
    lab = _onehot(rng, (hh, ww), o)
    bias = np.array([-0.4, 0.3, 0.1], np.float32)
    n = len(radii)
    wgt = rng.standard_normal((s, hh, ww, o, n)).astype(np.float32)

    def jfwd(q_, p_, b_):
        return jm.local_matching_bank_stacked(
            q_, p_, jnp.asarray(lab), b_, radii, atrous_rate=atrous,
            allow_downsample=True, dtype=jnp.float32, use_pallas=False)

    want = np.asarray(jfwd(jnp.asarray(q), jnp.asarray(prev),
                           jnp.asarray(bias)))
    grads = jax.grad(lambda *a: jnp.sum(jfwd(*a) * jnp.asarray(wgt)),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(prev),
                                        jnp.asarray(bias))
    tq = torch.from_numpy(q).requires_grad_()
    tp = torch.from_numpy(prev).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    got = local_matching_bank_stacked(
        tq, tp, torch.from_numpy(lab), tbias, radii, atrous_rate=atrous,
        allow_downsample=True, match=local_matching_min)
    (got * torch.from_numpy(wgt)).sum().backward()
    _close(got.detach(), want, what="forward")
    for name, t, jg in (("query", tq, grads[0]), ("prev", tp, grads[1]),
                        ("bias", tbias, grads[2])):
        assert np.abs(np.asarray(jg)).max() > 0, name
        _close(t.grad, jg, what=f"d {name}")


def test_gradcheck_global_matching_min():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((9, 5))).requires_grad_()
    r = torch.from_numpy(rng.standard_normal((23, 5))).requires_grad_()
    lab = torch.from_numpy(_onehot(rng, (23,), 3).astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda a, b: global_matching_min(a, b, lab), (q, r))


@pytest.mark.parametrize("atrous", [1, 2])
def test_gradcheck_local_matching_min(atrous):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 7, 4))).requires_grad_()
    ys = torch.from_numpy(rng.standard_normal((2, 6, 7, 4))).requires_grad_()
    lab = torch.from_numpy(_onehot(rng, (6, 7), 3).astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda a, b: local_matching_min(a, b, lab, (2, 4), atrous), (x, ys))
