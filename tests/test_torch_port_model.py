"""The port's model (``rvos_tpu_torch.models``) against the JAX package's,
on one module-scoped JAX ``init_model`` of a tiny config at 33×33.

Weights go through ``rvos_tpu_torch.weights.from_jax_params`` and load
strictly; inputs are made with numpy from a seed.  Parity mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvos_tpu.configs import tiny_test
from rvos_tpu.engine.checkpoint import _flatten
from rvos_tpu.models import AOCNet, DecoderMemory
from rvos_tpu.models.aocnet import init_model, precompact_bank

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.device import configure_precision
import rvos_tpu_torch.models.aocnet as taocnet
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.models import DecoderMemory as TDecoderMemory
from rvos_tpu_torch.models import precompact_bank as t_precompact_bank
from rvos_tpu_torch.weights import from_jax_params

H = W = 33
CFG_KW = dict(MODEL_MULTI_LOCAL_DISTANCE=(2, 4), MODEL_MAX_OBJ_NUM=3)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test(**CFG_KW)
    model, variables = init_model(cfg, jax.random.PRNGKey(0), (H, W))
    tcfg = tconfigs.tiny_test(**CFG_KW)
    configure_precision(tcfg)
    tmodel = TAOCNet(tcfg).eval()
    sd = from_jax_params(_flatten(jax.device_get(variables["params"])))
    tmodel.load_state_dict(sd, strict=True)
    imgs = np.random.default_rng(3).standard_normal((3, H, W, 3)
                                                    ).astype(np.float32)
    emb, low = model.apply(variables, jnp.asarray(imgs),
                           method=AOCNet.extract_feature)
    return cfg, model, variables, tmodel, imgs, np.asarray(emb), np.asarray(low)


def test_port_config_matches_jax_config():
    from rvos_tpu.configs import PRESETS
    for name, fn in PRESETS.items():
        assert tconfigs.PRESETS[name]().__dict__ == fn().__dict__


def test_from_jax_params_loads_strictly(setup):
    _, _, variables, tmodel, *_ = setup
    flat = _flatten(jax.device_get(variables["params"]))
    sd = from_jax_params(flat)
    assert len(sd) == len(flat)
    assert set(sd) == set(tmodel.state_dict())
    gct = sd["dynamic_seghead.layer1.GCT1.alpha"]
    assert gct.shape == (1, 164, 1, 1)
    assert sd["feature_extracter.backbone.layer1.0.downsample.0.weight"
              ].shape == (256, 64, 1, 1)
    assert sd["dynamic_seghead.IA1.IA.weight"].shape == (164, 400)


def test_extract_feature_matches_jax(setup):
    _, _, _, tmodel, imgs, emb, low = setup
    with torch.no_grad():
        temb, tlow = tmodel.extract_feature(_t(imgs))
    np.testing.assert_allclose(temb.numpy(), emb, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tlow.numpy(), low, atol=2e-4, rtol=1e-3)


def _frame_inputs(cfg, emb):
    o = cfg.MODEL_MAX_OBJ_NUM
    h, w = emb.shape[1:3]
    lab = np.zeros((h, w), np.int32)
    lab[1:4, 1:5] = 1
    lab[5:8, 2:7] = 2
    prev_lab = np.roll(lab, 1, axis=1)
    onehot = np.eye(o, dtype=np.float32)[lab]
    prev_onehot = np.eye(o, dtype=np.float32)[prev_lab]
    return onehot, prev_onehot


def _kmeans_draws(key, o, r):
    return np.stack([np.asarray(jax.random.uniform(k, (r,), minval=0.5,
                                                   maxval=1.0))
                     for k in jax.random.split(key, o)])


@pytest.mark.parametrize("matching", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("bank", ["inline", "precompacted"])
def test_segment_frame_matches_jax(setup, bank, matching, monkeypatch):
    """``bfloat16`` matching rounds the matching operands to bf16 at the
    same places on both sides.  In ``mixed`` mode the JAX package's CPU
    path runs the global stream through its XLA online-min, which
    ignores ``mixed`` and computes in float32, while its TPU kernel and
    the port's kernel 1 round the cross term's operands to bf16 (held
    against the Pallas kernel in ``test_torch_port_ops.py``).  So the
    mixed case runs the port's global stream in float32 too, and holds
    every other stream's mixed arithmetic to the JAX package's."""
    cfg, model, variables, tmodel, _, emb, low = setup
    if matching == "mixed":
        seg = taocnet.global_matching_flat_segmented
        monkeypatch.setattr(taocnet, "global_matching_flat_segmented",
                            lambda *a, **kw: seg(*a, **{**kw, "mixed": False}))
    if matching != "float32":
        cfg = cfg.replace(MATCHING_DTYPE=matching)
        model = AOCNet(cfg)
        sd = tmodel.state_dict()
        tmodel = TAOCNet(tmodel.cfg.replace(MATCHING_DTYPE=matching)).eval()
        tmodel.load_state_dict(sd, strict=True)
    o = cfg.MODEL_MAX_OBJ_NUM
    h, w = emb.shape[1:3]
    onehot, prev_onehot = _frame_inputs(cfg, emb)
    obj_valid = np.array([1.0, 1.0, 1.0], np.float32)
    slot_valid = np.ones((1,), np.float32)
    ref_emb, ref_oh = emb[0][None], onehot[None]
    key = jax.random.PRNGKey(7)
    if bank == "precompacted":
        fe, fl, fo = precompact_bank(cfg, jnp.asarray(ref_emb),
                                     jnp.asarray(ref_oh), jnp.asarray(slot_valid))
        flat = (fe, fl, fo)
        r = fe.shape[0]
    else:
        flat = (None, None, None)
        r = h * w
    mem = DecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256)
    logits, new_mem = model.apply(
        variables, jnp.asarray(emb[2]), jnp.asarray(low[2]),
        jnp.asarray(ref_emb), jnp.asarray(ref_oh), jnp.asarray(slot_valid),
        jnp.asarray(emb[1]), jnp.asarray(prev_onehot), jnp.asarray(obj_valid),
        mem, key, False, *flat, method=AOCNet.segment_frame)
    logits = np.asarray(logits)

    scores = _t(_kmeans_draws(key, o, r))
    if bank == "precompacted":
        tflat = t_precompact_bank(tmodel.cfg, _t(ref_emb), _t(ref_oh),
                                  _t(slot_valid))
        np.testing.assert_array_equal(tflat[2].numpy(), np.asarray(fo))
        np.testing.assert_array_equal(tflat[0].numpy(), np.asarray(fe))
    else:
        tflat = (None, None, None)
    with torch.no_grad():
        tlogits, tmem = tmodel.segment_frame(
            _t(emb[2]), _t(low[2]), _t(ref_emb), _t(ref_oh), _t(slot_valid),
            _t(emb[1]), _t(prev_onehot), _t(obj_valid), TDecoderMemory(),
            scores, *tflat)
        # a second frame reads the memory; slot 1 stays as it was
        _, tmem2 = tmodel.segment_frame(
            _t(emb[1]), _t(low[1]), _t(ref_emb), _t(ref_oh), _t(slot_valid),
            _t(emb[2]), _t(prev_onehot), _t(obj_valid), tmem, scores, *tflat)
    tlogits = tlogits.numpy()
    assert tlogits.shape == (o, h, w)
    diff = np.abs(tlogits - logits).max()
    assert diff < 1e-2, diff
    assert (tlogits.argmax(0) == logits.argmax(0)).mean() > 0.999
    np.testing.assert_allclose(
        tmem.slot0.permute(0, 2, 3, 1).numpy(), np.asarray(new_mem.slots[0]),
        atol=1e-3, rtol=1e-3)
    assert torch.equal(tmem2.slot1, tmem.slot1)
    assert not torch.equal(tmem2.slot0, tmem.slot0)


def test_segment_frame_masks_invalid_objects(setup):
    cfg, _, _, tmodel, _, emb, low = setup
    o = cfg.MODEL_MAX_OBJ_NUM
    h, w = emb.shape[1:3]
    onehot, prev_onehot = _frame_inputs(cfg, emb)
    obj_valid = _t(np.array([1.0, 1.0, 0.0], np.float32))
    scores = torch.full((o, h * w), 0.75)
    with torch.no_grad():
        logits, _ = tmodel.segment_frame(
            _t(emb[2]), _t(low[2]), _t(emb[0][None]), _t(onehot[None]),
            torch.ones(1), _t(emb[1]), _t(prev_onehot), obj_valid,
            TDecoderMemory(), scores)
    assert torch.isfinite(logits[:2]).all()
    assert (logits[2] <= -1e8).all()
