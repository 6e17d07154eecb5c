"""The MobileNetV2 backbone (``MODEL_BACKBONE="mobilenet"``) of the port
against the JAX package's, on the CPU in float32, with the JAX package's
own initialisation carried to the port by ``from_jax_params`` (loaded
strictly).

Tolerances.  Backbone features and ``extract_feature`` within 1e-5 of
the largest |value| (measured: at most 2.4e-6); one frame's
``segment_frame`` logits, after the calibration decoder, within 1e-4
(measured: 1.02e-5).  The streaming evaluator's masks on ≥ 99.9 % of
every frame of the JAX evaluator's, as ``test_torch_port_eval.py`` holds
the ResNet.  The train step is ``test_torch_port_mobilenet_train.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvos_tpu.configs import tiny_test
from rvos_tpu.data.datasets import SyntheticEval
from rvos_tpu.engine.checkpoint import _flatten
from rvos_tpu.engine.eval import Evaluator
from rvos_tpu.models.aocnet import AOCNet, init_model

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.data import SyntheticEval as TSyntheticEval
from rvos_tpu_torch.engine import Evaluator as TEvaluator
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.models.deeplab import DeepLab
from rvos_tpu_torch.models.mobilenet import MobileNetV2
from rvos_tpu_torch.weights import from_jax_params
from torch_port_cases import SIZE, jax_kmeans_scores, port_model_from_jax
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

CFG_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
              MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None, TEST_BANK_CAPACITY=3,
              MEM_EVERY=2, TEST_FRAME_CHUNK=1, MODEL_BACKBONE="mobilenet")


@pytest.fixture(scope="module")
def jax_model():
    cfg = tiny_test(**CFG_KW)
    model, variables = init_model(cfg, jax.random.PRNGKey(0), SIZE)
    return cfg, model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, _, variables = jax_model
    return port_model_from_jax(tconfigs.tiny_test(**CFG_KW), variables).eval()


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _frames(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + SIZE + (3,)).astype(np.float32)


def test_from_jax_params_loads_strictly(jax_model):
    """Every MobileNet parameter maps (depthwise kernels (3, 3, 1, C) to
    grouped conv weights (C, 1, 3, 3)) and the ASPP and decoders take the
    320- and 24-wide inputs."""
    _, _, variables = jax_model
    sd = from_jax_params(_flatten(jax.device_get(variables["params"])))
    model = TAOCNet(tconfigs.tiny_test(**CFG_KW))
    model.load_state_dict(sd, strict=True)
    bb = model.feature_extracter.backbone
    assert isinstance(bb, MobileNetV2) and bb.n_blocks == 17
    assert bb.block_1.depthwise.conv.weight.shape == (96, 1, 3, 3)
    assert bb.block_1.depthwise.conv.groups == 96
    assert model.feature_extracter.aspp.aspp1_conv.in_channels == 320
    assert model.feature_extracter.decoder.conv1.in_channels == 24
    assert model.dynamic_seghead.conv_sc.in_channels == 24


def test_backbone_features_match_jax(jax_model, port_model):
    """MobileNetV2 alone: the 320-wide stride-16 features (the last
    stages dilated) and the 24-wide stride-4 low level."""
    from rvos_tpu.models.mobilenet import MobileNetV2 as JMobileNetV2

    _, _, variables = jax_model
    x = _frames()
    bb_vars = {"params": variables["params"]["feature_extracter"]["backbone"]}
    jf, jl = JMobileNetV2(16).apply(bb_vars, jnp.asarray(x))
    with torch.no_grad():
        f, low = port_model.feature_extracter.backbone(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert f.shape == (2, 320, 3, 3) and low.shape == (2, 24, 9, 9)
    assert _rel(f.permute(0, 2, 3, 1), jf) <= 1e-5
    assert _rel(low.permute(0, 2, 3, 1), jl) <= 1e-5


def test_extract_feature_matches_jax(jax_model, port_model):
    cfg, model, variables = jax_model
    x = _frames(3, seed=1)
    je, jl = model.apply(variables, jnp.asarray(x), True,
                         method=AOCNet.extract_feature)
    with torch.no_grad():
        e, low = port_model.extract_feature(torch.from_numpy(x))
    assert _rel(e, je) <= 1e-5
    assert _rel(low, jl) <= 1e-5


def test_segment_frame_matches_jax(jax_model, port_model):
    """One frame against a one-slot bank with two objects, JAX's k-means
    draws handed to the port: logits within 1e-4 of their scale."""
    from rvos_tpu.models import DecoderMemory as JMemory
    from rvos_tpu_torch.models import DecoderMemory

    cfg, model, variables = jax_model
    x = _frames(3, seed=2)
    emb, low = model.apply(variables, jnp.asarray(x), True,
                           method=AOCNet.extract_feature)
    h, w = emb.shape[1:3]
    lab = np.zeros((h, w), np.int32)
    lab[1:5, 1:4] = 1
    lab[5:8, 4:9] = 2
    o = cfg.MODEL_MAX_OBJ_NUM
    onehot = np.eye(o, dtype=np.float32)[lab]
    ov = np.array([1, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(3)
    mem = JMemory.empty(o, (h + 1) // 2, (w + 1) // 2, 256, jnp.float32)
    jlog, _ = model.apply(
        variables, emb[2], low[2], emb[0][None], jnp.asarray(onehot)[None],
        jnp.ones((1,)), emb[1], jnp.asarray(onehot), jnp.asarray(ov), mem,
        key, False, method=AOCNet.segment_frame)
    # the k-means draws of that key, as JAX's cluster_objects makes them
    rows = h * w
    scores = np.stack([np.asarray(jax.random.uniform(
        k, (rows,), minval=0.5, maxval=1.0)) for k in jax.random.split(key, o)])
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    with torch.no_grad():
        logits, _ = port_model.segment_frame(
            t(emb[2]), t(low[2]), t(emb[0])[None], t(onehot)[None],
            torch.ones(1), t(emb[1]), t(onehot), t(ov),
            DecoderMemory.empty(o, (h + 1) // 2, (w + 1) // 2),
            torch.from_numpy(scores))
    assert logits.shape == (o, h, w)
    valid = ov.astype(bool)
    assert _rel(logits[valid], np.asarray(jlog)[valid]) <= 1e-4


def test_evaluator_masks_match_jax(jax_model):
    """The whole video through both streaming evaluators in parity mode
    (frame by frame, two bank appends): masks agree on ≥ 99.9 % of
    every frame."""
    cfg, model, variables = jax_model
    seq = SyntheticEval(size=SIZE, n_seqs=1, n_frames=6)[0]
    want = Evaluator(cfg, model, variables).evaluate_sequence(seq)["results"]
    tcfg = tconfigs.tiny_test(**CFG_KW)
    ev = TEvaluator(tcfg, port_model_from_jax(tcfg, variables),
                    device="cpu", kmeans_scores=jax_kmeans_scores)
    got = ev.evaluate_sequence(TSyntheticEval(size=SIZE, n_seqs=1,
                                              n_frames=6)[0])["results"]
    assert sorted(got) == sorted(want) == [f"{i:05d}.jpg"
                                           for i in range(1, 6)]
    assert any(len(np.unique(m)) > 1 for m in want.values())
    for name, mask in want.items():
        agree = (got[name] == mask).mean()
        assert agree >= 0.999, (name, agree)


def test_dilation_replaces_stride_after_output_stride_16():
    bb = MobileNetV2(16)
    convs = [getattr(bb, f"block_{i}").depthwise.conv
             for i in range(bb.n_blocks)]
    assert [c.stride[0] for c in convs].count(2) == 3
    assert [c.dilation[0] for c in convs[13:]] == [2, 2, 2, 2]
    assert all(c.dilation[0] == 1 for c in convs[:13])
    with torch.no_grad():
        f, low = DeepLab(16, "mobilenet", 0.0)(torch.zeros(1, 3, 65, 65))
    assert f.shape == (1, 256, 17, 17) and low.shape == (1, 24, 17, 17)


def test_low_level_override_is_refused():
    with pytest.raises(ValueError, match="MODEL_LOW_LEVEL_INPLANES"):
        TAOCNet(tconfigs.tiny_test(MODEL_BACKBONE="mobilenet",
                                   MODEL_LOW_LEVEL_INPLANES=48))
