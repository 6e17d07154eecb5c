"""The port's learning-rate schedule and optimizer against the JAX
package's, on the CPU.

* ``lr_schedule`` at every step of a warm-up + poly(0.9) run and of a
  warm-up + cosine run, and four steps past the end: within 1e-6
  relative.
* ``TrainOptimizer`` against ``build_optimizer``'s optax chain (clip by
  global norm → coupled weight decay with the GCT-``beta`` exemption →
  nesterov SGD; ``set_to_zero`` for the frozen group) and the JAX train
  step's non-finite skip, on one small tree with the same gradients
  over six updates: the second clipped (norm 40 > 5), the fourth NaN
  (skipped: parameters and update count unchanged), with and without a
  frozen ``feature_extracter``.  Parameters within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from rvos_tpu.configs import tiny_test as j_tiny
from rvos_tpu.engine.learning import build_optimizer
from rvos_tpu.engine.learning import lr_schedule as j_lr_schedule

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.engine.learning import (TrainOptimizer, lr_schedule,
                                            param_groups)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

SCHEDULES = {
    "poly": dict(TRAIN_LR=0.01, TRAIN_WARM_UP_STEPS=20, TRAIN_TOTAL_STEPS=300,
                 TRAIN_POWER=0.9),
    "cosine": dict(TRAIN_LR=0.2, TRAIN_WARM_UP_STEPS=7, TRAIN_TOTAL_STEPS=251,
                   TRAIN_COSINE_DECAY=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    kw = SCHEDULES[name]
    want_fn = j_lr_schedule(j_tiny(**kw))
    got_fn = lr_schedule(tiny_test(**kw))
    steps = np.arange(kw["TRAIN_TOTAL_STEPS"] + 5)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps)))
    got = np.array([got_fn(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


SHAPES = {"feature_extracter/conv/w": (4, 3), "feature_extracter/conv/b": (4,),
          "gct/alpha": (1, 5), "gct/beta": (1, 5), "head/w": (5, 2),
          "head/b": (2,)}


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature_extracter = nn.Module()
        self.feature_extracter.conv = nn.Module()
        self.gct = nn.Module()
        self.head = nn.Module()
        for path, shape in SHAPES.items():
            *mods, leaf = path.split("/")
            m = self
            for p in mods:
                m = getattr(m, p)
            setattr(m, leaf, nn.Parameter(torch.zeros(shape)))


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *mods, leaf = k.split("/")
        for p in mods:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _grads(rng):
    seq = []
    for i in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == 1:
            g = {k: v * 20.0 for k, v in g.items()}
        if i == 3:
            g["head/w"][0, 0] = np.nan
        seq.append(g)
    return seq


@pytest.mark.parametrize("freeze", [False, True], ids=["all", "frozen_backbone"])
def test_optimizer_matches_optax_chain(freeze):
    kw = dict(TRAIN_LR=0.05, TRAIN_WARM_UP_STEPS=2, TRAIN_TOTAL_STEPS=10,
              TRAIN_WEIGHT_DECAY=0.01, TRAIN_CLIP_GRAD_NORM=5.0,
              MODEL_GCT_BETA_WD=False, MODEL_FREEZE_BACKBONE=freeze,
              TRAIN_SKIP_NONFINITE=True)
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}

    params = _nest({k: jnp.asarray(v) for k, v in init.items()})
    tx = build_optimizer(j_tiny(**kw), params)
    opt = tx.init(params)

    model = _Tiny()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[name.replace(".", "/")]))
    cfg = tiny_test(**kw)
    topt = TrainOptimizer(cfg, model)
    groups = param_groups(cfg, model)
    assert [n for n, _ in groups["no_decay"]] == ["gct.beta"]
    assert len(groups["frozen"]) == (2 if freeze else 0)

    for i, g in enumerate(_grads(rng)):
        jg = _nest({k: jnp.asarray(v) for k, v in g.items()})
        # the JAX train step: global norm, update, select on finiteness
        norm = optax.global_norm(jg)
        updates, new_opt = tx.update(jg, opt, params)
        new_params = optax.apply_updates(params, updates)
        ok = jnp.isfinite(norm)
        params = jax.tree.map(lambda n, o: jnp.where(ok, n, o), new_params,
                              params)
        opt = jax.tree.map(lambda n, o: jnp.where(ok, n, o)
                           if hasattr(n, "dtype") else n, new_opt, opt)

        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name.replace(".", "/")].copy())
        res = topt.step()
        assert res["applied"] == bool(ok)
        np.testing.assert_allclose(float(res["grad_norm"]), float(norm),
                                   rtol=1e-6)
        assert topt.count == (i + 1 if i < 3 else i)
        flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       flat[name.replace(".", "/")],
                                       rtol=0, atol=1e-6, err_msg=f"{i} {name}")
        if freeze:
            np.testing.assert_array_equal(
                model.feature_extracter.conv.w.detach().numpy(),
                init["feature_extracter/conv/w"])
