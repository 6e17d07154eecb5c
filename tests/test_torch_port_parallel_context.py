"""Context parallelism of the port (``rvos_tpu_torch.parallel``) against
the JAX package's over ``tests/conftest.py``'s 8 virtual CPU devices, and
the port's device lists (``parallel.mesh``).

On the CPU a shard runs kernel 3's plain version, so a list that repeats
the CPU (``[cpu] * n``) drives the sharded code: the padding, the row
and bank splits, the copies and the gather.  Inputs are made with numpy
from a seed.  Tolerances: JAX's own where both sides compute the same
float32 function (``tests/test_context_parallel.py``: ``atol=1e-4``),
bit for bit against the port's unsharded path (the rows of a query
shard are the same rows; a min over bank shards is exact).
``segment_frame`` against JAX: the port's unsharded ``segment_frame``
already parts from JAX's by 1.9e-4 at this setting (both sides'
convolutions and matmuls round differently), above the ``atol=1e-4``
JAX holds between its own sharded and unsharded runs, so there the port
is held to add nothing: its sharded logits equal its unsharded ones bit
for bit, JAX's sharded equal JAX's unsharded within JAX's bar, and the
gap between the two packages' sharded logits is the unsharded gap, below
``tests/test_torch_port_model.py``'s bars (max |Δ| < 1e-2, argmax
agreement > 0.999)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rvos_tpu.configs import tiny_test
from rvos_tpu.engine.checkpoint import _flatten
from rvos_tpu.models import AOCNet
from rvos_tpu.models.aocnet import init_model
from rvos_tpu.parallel import ambient_mesh_ctx, make_mesh
from rvos_tpu.parallel.context import (global_matching_bank_sharded,
                                       global_matching_context_parallel)

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.device import configure_precision
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.models import DecoderMemory as TDecoderMemory
from rvos_tpu_torch.ops import global_matching_flat
from rvos_tpu_torch.parallel import (cp_mesh, global_matching_bank_sharded
                                     as t_bank_sharded,
                                     global_matching_context_parallel
                                     as t_context_parallel, make_mesh
                                     as t_make_mesh, resolved_cp_devices)
from rvos_tpu_torch.weights import from_jax_params
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _inputs(seed, h, w, c, o, r):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((h, w, c)).astype(np.float32)
    re = rng.standard_normal((r, c)).astype(np.float32)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, o, size=(r,))]
    bias = (rng.standard_normal((o,)) * 0.1).astype(np.float32)
    return q, re, lab, bias


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs conftest's 8 virtual devices")
    return Mesh(np.array(jax.devices()[:8]), ("model",))


@pytest.mark.parametrize("fn,r", [("rows", 50), ("bank", 53)])
def test_sharded_global_matching_matches_jax(fn, r):
    """The shapes of ``tests/test_context_parallel.py`` (R = 53 does not
    divide by 8: bank padding), 8 shards on both sides."""
    q, re, lab, bias = _inputs(0, 9 if fn == "rows" else 7,
                               11 if fn == "rows" else 9, 8, 3, r)
    jfn = (global_matching_context_parallel if fn == "rows"
           else global_matching_bank_sharded)
    tfn = t_context_parallel if fn == "rows" else t_bank_sharded
    want = np.asarray(jfn(*map(jnp.asarray, (q, re, lab, bias)), _jax_mesh()))
    got = tfn(*map(_t, (q, re, lab, bias)), [CPU] * 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    plain = global_matching_flat(*map(_t, (q, re, lab, bias)))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_global_matching_equals_unsharded(n, mixed):
    """Query rows M = 7·13 = 91 and bank rows R = 101 split 2, 3 and 4
    ways (padding at 2 and 4 for M, at 2, 3 and 4 for R), float32 and
    mixed matching: both equal the unsharded flat route bit for bit."""
    q, re, lab, bias = map(_t, _inputs(n, 7, 13, 16, 4, 101))
    lab[:, 3] = 0.0          # an object with no bank row: padding rows
    plain = global_matching_flat(q, re, lab, bias, mixed=mixed)
    for fn in (t_context_parallel, t_bank_sharded):
        assert torch.equal(fn(q, re, lab, bias, [CPU] * n, mixed=mixed),
                           plain)


def _jax_model():
    base = tiny_test(MODEL_MULTI_LOCAL_DISTANCE=(1, 2), MODEL_MAX_OBJ_NUM=3,
                     USE_PALLAS=False)
    return base, *init_model(base, jax.random.PRNGKey(0), (33, 33))


def test_segment_frame_context_parallel_matches_jax():
    """``full_forward`` (JAX) and the port's extraction + ``segment_frame``
    at ``MESH_MODEL_AXIS=4``: JAX under ``make_mesh(data=2, model=4)``,
    the port over ``[cpu] * 4``; then the degraded case, four model
    shards asked with two devices (no mesh in JAX, ``cp_mesh`` None in
    the port), which runs the unsharded path on both sides."""
    _jax_mesh()
    base, model, variables = _jax_model()
    rng = np.random.default_rng(1)
    imgs = jnp.asarray(rng.standard_normal((3, 33, 33, 3)).astype(np.float32))
    emb, low = model.apply(variables, imgs, method=AOCNet.extract_feature)
    labels = jnp.zeros(emb.shape[1:3], jnp.int32).at[2:6, 2:6].set(1)

    def jax_run(cfg, ctx):
        m = AOCNet(cfg)
        with ctx:
            return np.asarray(jax.jit(lambda v, x, lb: m.apply(
                v, x, lb, method=AOCNet.full_forward))(variables, imgs,
                                                       labels))

    want = jax_run(base, contextlib.nullcontext())
    jax_cp = jax_run(base.replace(MESH_MODEL_AXIS=4),
                     ambient_mesh_ctx(make_mesh(data=2, model=4)))
    np.testing.assert_allclose(jax_cp, want, rtol=1e-5, atol=1e-4)

    tcfg = tconfigs.tiny_test(MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
                              MODEL_MAX_OBJ_NUM=3, MESH_MODEL_AXIS=4)
    configure_precision(tcfg)
    tm = TAOCNet(tcfg).eval()
    tm.load_state_dict(from_jax_params(_flatten(jax.device_get(
        variables["params"]))), strict=True)
    o = 3
    e, lo = _t(emb), _t(low)
    h, w = e.shape[1:3]
    oh = torch.nn.functional.one_hot(_t(labels).long(), o).float()
    r = h * w
    if tcfg.MATCHING_MAX_REF_PIXELS:
        r = min(r, tcfg.MATCHING_MAX_REF_PIXELS)
    scores = _t(np.stack([np.asarray(jax.random.uniform(
        k, (r,), minval=0.5, maxval=1.0))
        for k in jax.random.split(jax.random.PRNGKey(0), o)]))

    def port(devices):
        with torch.no_grad():
            return tm.segment_frame(
                e[2], lo[2], e[0][None], oh[None], torch.ones(1), e[1], oh,
                torch.ones(o), TDecoderMemory.empty(o, (h + 1) // 2,
                                                    (w + 1) // 2, 256),
                scores,
                cp_devices=resolved_cp_devices(tcfg, devices))[0].numpy()

    unsharded = port([CPU])
    sharded = port([CPU] * 4)
    degraded = port([CPU] * 2)
    assert resolved_cp_devices(tcfg, [CPU] * 4) == [CPU] * 4
    assert resolved_cp_devices(tcfg, [CPU] * 2) is None
    np.testing.assert_array_equal(sharded, unsharded)
    np.testing.assert_array_equal(degraded, unsharded)
    gap = np.abs(unsharded - want).max()
    assert np.abs(sharded - jax_cp).max() <= max(gap, 1e-4) < 1e-2
    assert (sharded.argmax(0) == jax_cp.argmax(0)).mean() > 0.999

    jax_degraded = jax_run(base.replace(MESH_MODEL_AXIS=4),
                           contextlib.nullcontext())
    np.testing.assert_allclose(jax_degraded, want, rtol=1e-5, atol=1e-4)


class _Cfg:
    def __init__(self, model, data=8):
        self.MESH_MODEL_AXIS, self.MESH_DATA_AXIS = model, data


@pytest.mark.parametrize("n_dev,model,data,want", [
    (8, 4, 8, (2, 4)), (8, 2, 3, (3, 2)), (4, 4, 8, (1, 4)),
    (2, 4, 8, None), (8, 1, 8, None)])
def test_cp_mesh_shapes_match_jax(n_dev, model, data, want):
    """The port's mesh as device lists has the JAX mesh's shape and
    device order, and degrades to None where JAX's does."""
    from rvos_tpu.parallel.mesh import cp_mesh as j_cp_mesh
    cfg = _Cfg(model, data)
    if len(jax.devices()) < n_dev:
        pytest.skip("needs conftest's 8 virtual devices")
    jm = j_cp_mesh(cfg, devices=jax.devices()[:n_dev])
    cards = [torch.device("cuda", i) for i in range(n_dev)]
    tm = cp_mesh(cfg, cards)
    if want is None:
        assert jm is None and tm is None
        return
    assert tuple(jm.devices.shape) == (len(tm), len(tm[0])) == want
    ids = [[d.id for d in row] for row in jm.devices]
    assert [[d.index for d in row] for row in tm] == ids


def test_make_mesh_rows():
    cards = [torch.device("cuda", i) for i in range(6)]
    assert t_make_mesh(2, 3, cards) == [cards[:3], cards[3:]]
    assert t_make_mesh(model=2, devices=cards) == [cards[:2], cards[2:4],
                                                   cards[4:]]
    with pytest.raises(ValueError):
        t_make_mesh(3, 3, cards)
