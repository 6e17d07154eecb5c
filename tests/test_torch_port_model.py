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
from rvos_tpu.engine.checkpoint import _flatten, load_pretrained
from rvos_tpu.models import AOCNet, DecoderMemory
from rvos_tpu.models.aocnet import init_model, precompact_bank

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.device import configure_precision
import rvos_tpu_torch.models.aocnet as taocnet
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.models import DecoderMemory as TDecoderMemory
from rvos_tpu_torch.models import precompact_bank as t_precompact_bank
from rvos_tpu_torch.weights import from_jax_params, load_reference_checkpoint
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

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


# the evaluator's bank layouts besides the default occupancy bank; a cap of
# 64 rows (of the 81 a 9×9 embedding gives) makes the fg-union compaction
# drop rows and the uniform layout fill its 1024-row quotas
_LAYOUTS = {
    "cap0": dict(MATCHING_MAX_REF_PIXELS=0),
    "unsegmented": dict(MATCHING_MAX_REF_PIXELS=64,
                        MATCHING_SEGMENTED_BANK=False),
    "uniform": dict(MATCHING_MAX_REF_PIXELS=64, MATCHING_OCCUPANCY_BANK=False),
}


def _check_segment_frame(setup, bank, matching, monkeypatch, **cfg_kw):
    """One frame of ``segment_frame`` on both sides, then a second port
    frame that reads the decoder memory.  Holds the logits (max |Δ| <
    1e-2, argmax agreement > 0.999), the memory slot (1e-3), the
    precompacted bank (identical rows) and the global stream's route:
    the segmented entry for a precompacted segmented bank with a cap,
    the flat entry for everything else."""
    cfg, model, variables, tmodel, _, emb, low = setup
    routes = []
    for name in ("global_matching_flat_segmented", "global_matching_flat"):
        fn = getattr(taocnet, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            routes.append(_name)
            if matching == "mixed":
                kw["mixed"] = False
            return _fn(*a, **kw)

        monkeypatch.setattr(taocnet, name, spy)
    if matching != "float32" or cfg_kw:
        cfg = cfg.replace(MATCHING_DTYPE=matching, **cfg_kw)
        model = AOCNet(cfg)
        sd = tmodel.state_dict()
        tmodel = TAOCNet(tmodel.cfg.replace(MATCHING_DTYPE=matching,
                                            **cfg_kw)).eval()
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
        if cfg.MATCHING_MAX_REF_PIXELS:
            r = min(r, cfg.MATCHING_MAX_REF_PIXELS)
    mem = DecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256)
    tmem0 = TDecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256)
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
        assert (tflat[2] is None) == (fo is None)
        if fo is not None:
            np.testing.assert_array_equal(tflat[2].numpy(), np.asarray(fo))
        np.testing.assert_array_equal(tflat[0].numpy(), np.asarray(fe))
        np.testing.assert_array_equal(tflat[1].numpy(), np.asarray(fl))
    else:
        tflat = (None, None, None)
    with torch.no_grad():
        tlogits, tmem = tmodel.segment_frame(
            _t(emb[2]), _t(low[2]), _t(ref_emb), _t(ref_oh), _t(slot_valid),
            _t(emb[1]), _t(prev_onehot), _t(obj_valid), tmem0,
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
        tmem.slots[0].permute(0, 2, 3, 1).numpy(),
        np.asarray(new_mem.slots[0]), atol=1e-3, rtol=1e-3)
    assert tmem.valid.tolist() == [True, True]
    assert torch.equal(tmem2.slots[1], tmem.slots[1])
    assert not torch.equal(tmem2.slots[0], tmem.slots[0])
    seg = (bank == "precompacted" and cfg.MATCHING_SEGMENTED_BANK
           and bool(cfg.MATCHING_MAX_REF_PIXELS))
    want_route = ("global_matching_flat_segmented" if seg
                  else "global_matching_flat")
    assert routes == [want_route] * 2, routes


@pytest.mark.parametrize("matching", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("bank", ["inline", "precompacted"])
def test_segment_frame_matches_jax(setup, bank, matching, monkeypatch):
    """The default occupancy bank.  ``bfloat16`` matching rounds the
    matching operands to bf16 at the same places on both sides.  In
    ``mixed`` mode the JAX package's CPU path runs the global stream
    through its XLA online-min, which ignores ``mixed`` and computes in
    float32, while its TPU kernels and the port's kernels 1 and 3 round
    the cross term's operands to bf16 (held against the Pallas kernels
    in interpret mode in ``test_torch_port_ops.py``).  So the mixed case
    runs the port's global stream in float32 too, through either entry
    point, and holds every other stream's mixed arithmetic to the JAX
    package's."""
    _check_segment_frame(setup, bank, matching, monkeypatch)


@pytest.mark.parametrize("matching", ["float32", "mixed"])
@pytest.mark.parametrize("bank", ["inline", "precompacted"])
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_segment_frame_layouts_match_jax(setup, layout, bank, matching,
                                         monkeypatch):
    """The other bank layouts: no cap and the fg-union compaction (B.3),
    the uniform-quota segmented bank (B.2 when precompacted, B.3 on the
    fg-union bank ``segment_frame`` compacts inline), at the same bar as
    the occupancy bank; mixed mode as there."""
    _check_segment_frame(setup, bank, matching, monkeypatch,
                         **_LAYOUTS[layout])


def test_reference_checkpoint_loads_like_jax(setup, tmp_path):
    """A reference-format ``.pth`` — the ``{"state_dict": ...}`` wrapper,
    DDP ``module.`` prefixes and a ``num_batches_tracked`` entry — made
    from perturbed JAX params, loaded through the JAX package's
    ``load_pretrained`` and through ``load_reference_checkpoint``: the
    same ``extract_feature`` (atol 2e-4, rtol 1e-3) and ``segment_frame``
    outputs (max |Δlogits| < 1e-2, argmax agreement > 0.999)."""
    cfg, model, variables, tmodel, imgs, _, _ = setup
    rng = np.random.default_rng(11)
    flat = _flatten(jax.device_get(variables["params"]))
    noisy = {k: (np.asarray(v) * (1.0 + 0.1 * rng.standard_normal(np.shape(v)))
                 ).astype(np.float32) for k, v in flat.items()}
    sd = {f"module.{k}": v for k, v in from_jax_params(noisy).items()}
    sd["module.feature_extracter.backbone.bn1.num_batches_tracked"] = \
        torch.zeros((), dtype=torch.long)
    path = str(tmp_path / "aoc.pth")
    torch.save({"state_dict": sd, "optimizer": {}}, path)

    params, removed, n_loaded = load_pretrained(variables["params"], path)
    assert removed == [] and n_loaded == len(flat)
    jvars = {"params": params}
    tm = load_reference_checkpoint(path, TAOCNet(tmodel.cfg)).eval()
    key_w = "semantic_embedding.embedding_conv.weight"
    assert not torch.equal(tm.state_dict()[key_w], tmodel.state_dict()[key_w])
    emb, low = model.apply(jvars, jnp.asarray(imgs),
                           method=AOCNet.extract_feature)
    emb, low = np.asarray(emb), np.asarray(low)
    with torch.no_grad():
        temb, tlow = tm.extract_feature(_t(imgs))
    np.testing.assert_allclose(temb.numpy(), emb, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tlow.numpy(), low, atol=2e-4, rtol=1e-3)

    o = cfg.MODEL_MAX_OBJ_NUM
    h, w = emb.shape[1:3]
    onehot, prev_onehot = _frame_inputs(cfg, emb)
    args = (emb[2], low[2], emb[0][None], onehot[None],
            np.ones((1,), np.float32), emb[1], prev_onehot,
            np.ones((o,), np.float32))
    key = jax.random.PRNGKey(7)
    mem = DecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256)
    logits, _ = model.apply(jvars, *map(jnp.asarray, args), mem, key, False,
                            method=AOCNet.segment_frame)
    logits = np.asarray(logits)
    with torch.no_grad():
        tlogits, _ = tm.segment_frame(
            *map(_t, args),
            TDecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256),
            _t(_kmeans_draws(key, o, h * w)))
    tlogits = tlogits.numpy()
    assert np.abs(tlogits - logits).max() < 1e-2
    assert (tlogits.argmax(0) == logits.argmax(0)).mean() > 0.999


def test_reference_checkpoint_refuses_what_does_not_fit(setup, tmp_path):
    """A missing file, a directory (the JAX package's orbax format) and a
    state dict that lacks a key all raise; nothing falls back."""
    *_, tmodel, _, _, _ = setup
    with pytest.raises(FileNotFoundError):
        load_reference_checkpoint(str(tmp_path / "none.pth"), tmodel)
    with pytest.raises(ValueError, match="orbax"):
        load_reference_checkpoint(str(tmp_path), tmodel)
    sd = dict(tmodel.state_dict())
    sd.pop("fg_bias")
    path = str(tmp_path / "short.pth")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="fg_bias"):
        load_reference_checkpoint(path, TAOCNet(tmodel.cfg))


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
            TDecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256), scores)
    assert torch.isfinite(logits[:2]).all()
    assert (logits[2] <= -1e8).all()
