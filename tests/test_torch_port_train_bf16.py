"""bfloat16 training in the port against the JAX package, on the CPU:
``TRAIN_COMPUTE_DTYPE="bfloat16"`` (bf16 forward on bf16 copies of the
float32 parameters) and ``MATCHING_DTYPE="bfloat16"`` (``--float16``:
float32 tower, bf16 matching operands), held stage by stage and piece by
piece.  The whole step of each route against JAX's is in a file of its
own (``test_torch_port_train_bf16_compute.py``, ``..._matching.py``):
each is one cold JAX compile.

A whole bf16-compute step has no power against another implementation
(two bf16 computations part as far as bf16 and float32 within a few
layers; ``test_torch_port_train_bf16_compute.py``).  The power for bf16
compute is in ``test_bf16_stage_matches_jax``: each stage of the route
alone (the route's own cast, ``engine.stage_check``) from the same bf16
inputs, where JAX's and the port's stages part by 2.6 to over 10⁵ times
less than the port's float32 stage does, on the stages whose bf16
arithmetic is the same on both sides; and in
``test_bf16_forward_runs_in_bf16`` and the pieces' tests (local matching
with exact ties, global matching, GCT, the resizes, GN within 2⁻⁶ of
JAX's folded form).

Port only: remat equals no remat, parameters, gradients and momentum
stay float32, and a non-finite batch is skipped, under bf16.
"""

import numpy as np
import pytest
import torch

from torch_port_threads import torch_threads  # noqa: F401 (autouse)

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.engine.train import Trainer, batch_to_device
from torch_port_cases import (BF16_ROUTES, STEP, TRAIN_KW, jax_params,
                              step_key, train_batch)


@pytest.mark.parametrize("name", sorted(BF16_ROUTES))
def test_bf16_forward_runs_in_bf16(name):
    """Every convolution, dense layer, group norm, GCT and frozen batch
    norm of the bf16 forward gets bf16 inputs and bf16 weights (the
    batch norms' statistics too), the extractor's outputs and the
    decoder memory it is handed are bf16, and the matching takes its route's
    operands; the parameters, their gradients and the optimizer's state
    stay float32."""
    cfg = tiny_test(**dict(TRAIN_KW, **BF16_ROUTES[name]))
    tr = Trainer(cfg, device="cpu", seed=0)
    want = torch.bfloat16 if name == "compute" else torch.float32
    seen, wrong = set(), []

    def check(mod, args, out):
        kind = type(mod).__name__
        seen.add(kind)
        weight = mod.alpha if kind == "GCT" else mod.weight
        dts = {args[0].dtype, weight.dtype}
        if kind == "FrozenBatchNorm2d":
            dts.add(mod.running_var.dtype)
        if dts != {want}:
            wrong.append((kind, dts))

    from torch import nn

    from rvos_tpu_torch.models.layers import GCT
    from rvos_tpu_torch.models.resnet import FrozenBatchNorm2d
    hooks = [m.register_forward_hook(check) for m in tr.model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear, nn.GroupNorm, GCT,
                               FrozenBatchNorm2d))]
    outs, memory = [], []
    hooks.append(tr.model.feature_extracter.register_forward_hook(
        lambda m, a, o: outs.append(o)))
    hooks.append(tr.model.dynamic_seghead.register_forward_pre_hook(
        lambda m, a: memory.append(a[2].slots.dtype)))
    from rvos_tpu_torch.ops import train_matching
    calls = []
    real_g, real_l = (train_matching.GlobalMatchingMin.apply,
                      train_matching.LocalMatchingMin.apply)

    def spy(real, tag):
        def f(*a):
            calls.append((tag, a[0].dtype, a[1].dtype))
            return real(*a)
        return f

    train_matching.GlobalMatchingMin.apply = spy(real_g, "global")
    train_matching.LocalMatchingMin.apply = spy(real_l, "local")
    try:
        m = tr.train_step(train_batch(), step_key())
    finally:
        train_matching.GlobalMatchingMin.apply = real_g
        train_matching.LocalMatchingMin.apply = real_l
        for h in hooks:
            h.remove()
    assert m["applied"] is True and np.isfinite(float(m["loss"]))
    assert {"Conv2d", "Linear", "GroupNorm", "GCT",
            "FrozenBatchNorm2d"} <= seen and not wrong, wrong
    assert all(t.dtype == want for o in outs for t in o)
    assert memory and set(memory) == {want}, memory
    # bf16 compute keeps float32 global operands under mixed matching and
    # takes bf16 ones for the local stream, as the JAX model does
    g_dt = torch.bfloat16 if name == "matching" else torch.float32
    assert set(calls) == {("global", g_dt, g_dt),
                          ("local", want, want)}, calls
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in tr.model.parameters()
               if p.grad is not None)
    state = tr.optimizer.sgd.state_dict()["state"]
    assert state and all(s["momentum_buffer"].dtype == torch.float32
                         for s in state.values())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("matching", ["mixed", "bfloat16"])
def test_bf16_remat_equals_no_remat(matching, one_thread):
    """Remat recomputes each extraction and frame of the bf16 forward
    (the bf16 parameter copies are made once per step, outside);
    gradients equal, with dropout on."""
    grads = []
    for remat in (False, True):
        cfg = tiny_test(**dict(TRAIN_KW, TRAIN_REMAT=remat,
                               MODEL_ASPP_DROPOUT=0.3,
                               TRAIN_COMPUTE_DTYPE="bfloat16",
                               MATCHING_DTYPE=matching))
        tr = Trainer(cfg, device="cpu", seed=1)
        loss, _ = tr._step_fn.loss_fn(
            batch_to_device(train_batch(2), torch.device("cpu")),
            STEP, step_key(), [11, 12, 13])
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in
                      tr.model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0,
                                   msg=n)


def test_bf16_nonfinite_batch_is_skipped():
    cfg = tiny_test(**dict(TRAIN_KW, TRAIN_COMPUTE_DTYPE="bfloat16"))
    tr = Trainer(cfg, device="cpu", seed=0)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    batch = train_batch()
    batch["curr_img"][0, 0, 5, 5, 0] = np.nan
    m = tr.train_step(batch, step_key())
    assert not np.isfinite(float(m["grad_norm"])) and m["applied"] is False
    assert tr.step == 1 and tr.optimizer.count == 0
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, before[n]), n
    m = tr.train_step(train_batch(1), step_key())
    assert m["applied"] is True and tr.optimizer.count == 1


# --- the bf16 route's stages alone, against JAX ----------------------------

# (output, input gradients, parameter gradients): relative L2 bars of
# the port's bf16 stage against JAX's bf16 stage, None where the stage's
# float32 run is not farther than the bar (no power: see below).
# Measured at these inputs (port bf16 | port float32, from JAX's bf16):
#   layer2_0  1.95e-4 2.8e-7 8.5e-5 | 3.17e-3 4.78e-2 5.52e-2
#   aspp      1.36e-4 2.42e-3 2.45e-3 | 3.45e-3 5.63e-2 5.89e-2
#   seg_IA1   0 1.01e-2 2.13e-2 | 2.72e-3 1.06e-2 2.13e-2
#   prehead   3.60e-3 5.17e-3 2.48e-2 | 3.95e-3 3.04e-2 3.94e-2
#   matching  1.96e-5 4.95e-2 0.184 | 9.13e-2 0.127 0.253
STAGE_BARS = {
    "layer2_0": (8e-4, 1e-4, 2e-3),
    "aspp": (7e-4, 1.2e-2, 1.2e-2),
    "seg_IA1": (3e-4, None, None),
    "prehead": (None, 1.2e-2, None),
    "matching": (1e-3, 8e-2, None),
}


def _jax_stage(cfg, params, name, xs, cot):
    """JAX's bf16 VJP of the stage on the same inputs: its float32
    parameters cast to bf16 inside the differentiated function, as
    ``rvos_tpu.engine.train``'s ``loss_fn`` casts them."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from rvos_tpu.configs import tiny_test as j_tiny
    from rvos_tpu.engine.checkpoint import _flatten
    from rvos_tpu.models import layers as jl
    from rvos_tpu.models.aocnet import AOCNet as JAOCNet
    from rvos_tpu.models.decoder import DecoderMemory as JMemory
    from rvos_tpu.models.deeplab import DeepLabASPP
    from rvos_tpu.models.resnet import ResNetBottleneck
    from rvos_tpu_torch.engine import stage_check as sc
    from rvos_tpu_torch.weights import from_jax_params

    def bf(tree):
        return jax.tree.map(lambda v: v.astype(jnp.bfloat16)
                            if v.dtype == jnp.float32 else v, tree)

    e = cfg.MODEL_SEMANTIC_EMBEDDING_DIM + cfg.MODEL_PRE_HEAD_EMBEDDING_DIM
    mods = {"layer2_0": (ResNetBottleneck(128, 2, 1, True),
                         "feature_extracter/backbone/layer2_0"),
            "aspp": (DeepLabASPP(), "feature_extracter/aspp"),
            "seg_IA1": (jl.IAGate(e), "dynamic_seghead/IA1"),
            "prehead": (jl.DynamicPreHead(cfg.MODEL_PRE_HEAD_EMBEDDING_DIM),
                        "dynamic_prehead")}
    if name == "matching":
        m = sc.matching_inputs(cfg, 0)
        model = JAOCNet(j_tiny(**TRAIN_KW))
        h, w = sc.MATCH_HW
        o = sc.MATCH_O
        b16 = {k: jnp.asarray(m[k]).astype(jnp.bfloat16)
               for k in ("low", "ref_onehot", "prev_onehot")}
        mem = JMemory(jnp.zeros((2, o, (h + 1) // 2, (w + 1) // 2,
                                 cfg.MODEL_HEAD_EMBEDDING_DIM), jnp.bfloat16),
                      jnp.zeros((2,), bool))

        def f(p, cur, ref, prev):
            seen = []

            def take(nxt, args, kw, ctx):
                if (isinstance(ctx.module, jl.DynamicPreHead)
                        and ctx.method_name == "__call__"):
                    seen.append(args[0])
                return nxt(*args, **kw)

            with fnn.intercept_methods(take):
                model.apply({"params": bf(p)}, cur, b16["low"], ref[None],
                            b16["ref_onehot"][None], jnp.ones((1,)), prev,
                            b16["prev_onehot"], jnp.asarray(m["obj_valid"]),
                            mem, jax.random.PRNGKey(0), True,
                            method=JAOCNet.segment_frame)
            return seen[0]
        sub, path = params, ""
    else:
        mod, path = mods[name]
        sub = params
        for part in path.split("/"):
            sub = sub[part]

        def f(p, *a):
            return mod.apply({"params": bf(p)}, *a)
    js = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    out, vjp = jax.vjp(f, sub, *js)
    if cot is None:
        cot = sc.output_gradient(out.shape, 0)
    g = vjp(jnp.asarray(cot).astype(out.dtype))
    pg = from_jax_params(_flatten(jax.device_get(g[0]), path))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(a.astype(jnp.float32)) for a in g[1:]],
            {k: v.numpy() for k, v in pg.items()})


@pytest.fixture(scope="module")
def stage_model():
    cfg = tiny_test(**TRAIN_KW)
    tr = Trainer(cfg, device="cpu", seed=0)
    return cfg, tr.model, jax_params(tr.model.state_dict())


@pytest.mark.parametrize("name", sorted(STAGE_BARS))
def test_bf16_stage_matches_jax(stage_model, name):
    """One stage of the bf16 route alone (``engine.stage_check``: the
    route's own cast of the float32 parameters and buffers, gradients to
    the float32 parameters) against JAX's bf16 VJP of the same stage,
    from the same bf16 inputs and output gradient: output, input
    gradients and parameter gradients within ``STAGE_BARS``, and the
    port's float32 run of the stage farther than each bar (power).

    The bars with power cover the frozen batch norms' cast (buffers
    here, parameters in JAX), native convolutions, the ASPP, the gates'
    dense layers, the pre-head's backward and the matching of bf16
    embeddings (global, cluster, proxy and local, to the maps and back
    to the embeddings).  The other stages have none against JAX: its
    stride-1 3×3 convolutions (``ShiftConv3x3``) sum nine bf16 taps in
    bf16, its group norm applies bf16 folded scales, and its VJPs sum
    broadcasts in bf16, where the port rounds once from float32: the
    port's bf16 stage is then as far from JAX's as its float32 one
    (measured 1.0–1.5 times; ``engine.stage_check.stage_gaps`` holds
    those stages card against CPU, where both sides are the port)."""
    from rvos_tpu_torch.engine import stage_check as sc

    cfg, model, params = stage_model
    xs, cot = sc.stage_inputs(cfg, name, 0)
    want = _jax_stage(cfg, params, name, xs, cot)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        got = sc.stage_vjp(model, name, xs, cot, dt, 0)
        assert set(got[2]) <= set(want[2])
        res[dt] = sc.gaps(got, (want[0], want[1],
                                {k: want[2][k] for k in got[2]}))
    print(name, "bf16", res[torch.bfloat16], "float32", res[torch.float32])
    for part, bar, b, f in zip(("output", "input grads", "param grads"),
                               STAGE_BARS[name], res[torch.bfloat16],
                               res[torch.float32]):
        if bar is not None:
            assert b <= bar < f, (part, b, bar, f)


# --- the bf16 pieces alone ---------------------------------------------

def _bf16(a):
    """numpy float32 → (JAX bf16 array, the same values as a torch bf16
    tensor)."""
    import jax.numpy as jnp
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(t):
    import jax.numpy as jnp
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _local_case(ties, radii, a, seed=0, h=9, w=11, c=6, s=2, o=3):
    """x [h, w, C], ys [S, h, w, C], labels, an output gradient; with
    ``ties`` the embeddings are small integers, so the bf16 cube is exact
    and full of ties."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-2, 3, (h, w, c)).astype(np.float32)
        ys = rng.integers(-2, 3, (s, h, w, c)).astype(np.float32)
    else:
        x = 3 * rng.standard_normal((h, w, c)).astype(np.float32)
        ys = 3 * rng.standard_normal((s, h, w, c)).astype(np.float32)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, o, (h, w))]
    lab[0, :3] = 0
    g = rng.standard_normal((s, h, w, o, len(radii))).astype(np.float32)
    return x, ys, lab, g


def _jax_local(x, ys, lab, g, radii, a):
    import jax
    import jax.numpy as jnp
    from rvos_tpu.ops.matching import _local_matching_online_stacked

    rd = tuple(int(r) // a for r in radii)
    pad_d = radii[-1] - radii[-1] % a
    a_max = pad_d // a
    out, vjp = jax.vjp(lambda x_, y_: _local_matching_online_stacked(
        x_, y_, jnp.asarray(lab), rd, a_max, 2 * a_max + 1, a, pad_d), x, ys)
    return (out,) + vjp(jnp.asarray(g))


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "normal"])
@pytest.mark.parametrize("radii,a", [((1, 2), 1), ((2, 4), 2),
                                     ((1, 3, 4), 1)])
def test_local_matching_min_bf16_matches_jax(ties, radii, a):
    """``LocalMatchingMin`` on bf16 inputs against JAX's scan on the same
    bf16 inputs: the mins equal bit for bit; the gradients within 2⁻⁶ of
    their largest |g| (bf16 sums in other orders: 1–2 ulps; measured at
    most 1.1 %).  The power check, on the tied cases: the float32 route
    on the same values (its ties go to the first winner) parts from
    JAX's gradient by more than 10 % (measured 19–25 %)."""
    from rvos_tpu_torch.ops.train_matching import local_matching_min

    x, ys, lab, g = _local_case(ties, radii, a)
    jx, tx = _bf16(x)
    jy, ty = _bf16(ys)
    jout, jdx, jdy = _jax_local(jx, jy, lab, g, radii, a)
    tx.requires_grad_()
    ty.requires_grad_()
    out = local_matching_min(tx, ty, torch.from_numpy(lab), radii, a)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and tx.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(jout))
    for got, want in ((tx.grad, jdx), (ty.grad, jdy)):
        err = np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max()
        assert err <= 2 ** -6, err
    if ties:
        fx = torch.from_numpy(_np(tx)).requires_grad_()
        fy = torch.from_numpy(_np(ty)).requires_grad_()
        local_matching_min(fx, fy, torch.from_numpy(lab), radii, a).backward(
            torch.from_numpy(g))
        err = np.abs(_np(fx.grad) - _np(jdx)).max() / np.abs(_np(jdx)).max()
        assert err > 0.1, err


def test_global_matching_min_bf16_matches_jax():
    """``GlobalMatchingMin`` on bf16 operands: float32 arithmetic from
    them (JAX's ``preferred_element_type``), the mins within 1e-6 of
    their scale and equal argmins (so equal gradient supports); the
    query's gradient comes back in bf16, within one bf16 ulp of JAX's."""
    import jax
    import jax.numpy as jnp
    from rvos_tpu.ops.matching import global_matching_min as jgm
    from rvos_tpu_torch.ops.train_matching import global_matching_min

    rng = np.random.default_rng(1)
    q = rng.standard_normal((70, 16)).astype(np.float32)
    r = rng.standard_normal((50, 16)).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 50)]
    g = rng.standard_normal((70, 3)).astype(np.float32)
    jq, tq = _bf16(q)
    jr, tr = _bf16(r)
    jl, tl = _bf16(lab)
    jout, vjp = jax.vjp(lambda a, b: jgm(a, b, jl), jq, jr)
    jdq, jdr = vjp(jnp.asarray(g))
    tq.requires_grad_()
    tr.requires_grad_()
    out = global_matching_min(tq, tr, tl)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    assert tq.grad.dtype == tr.grad.dtype == torch.bfloat16
    want = _np(jout)
    assert np.abs(_np(out) - want).max() <= 1e-6 * np.abs(want).max()
    for got, ref in ((tq.grad, jdq), (tr.grad, jdr)):
        ref = _np(ref)
        assert np.abs(_np(got) - ref).max() <= 2 ** -8 * np.abs(ref).max()


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def test_group_norm_bf16_matches_jax():
    """GN on a bf16 activation against JAX's folded bf16 form: the port
    keeps ``nn.GroupNorm`` (float32 statistics, the output rounded once),
    so the two part by the rounding of JAX's bf16 ``x·mul + off`` — on
    39.5 % of the entries here, by at most 0.031 (2⁻⁷ of the output's
    scale); the bar is 2⁻⁶ of it.  JAX's form cost 16–20 ms of an eval
    frame on the H100 (``models/layers.py``)."""
    import jax
    from rvos_tpu.models.layers import GN as JGN
    from rvos_tpu_torch.models.layers import GN

    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((3, 13, 17, 64)) + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jx, tx = _bf16(x)
    js, ts = _bf16(scale)
    jb, tb = _bf16(bias)
    want = _np(jax.jit(lambda v, p: JGN(32).apply(p, v))(
        jx, {"params": {"scale": js, "bias": jb}}))
    gn = GN(32, 64).bfloat16()
    gn.weight.data, gn.bias.data = ts, tb
    with torch.no_grad():
        got = gn(tx.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    err = np.abs(_np(_nhwc(got)) - want).max()
    assert err <= 2 ** -6 * np.abs(want).max(), err


def test_gct_bf16_matches_jax():
    """GCT on a bf16 activation (the width not a multiple of 8): JAX's
    8-wide partial sums of bf16 squares, equal bit for bit; float32 sums
    of float32 squares part from it (power)."""
    import jax
    from rvos_tpu.models.layers import GCT as JGCT
    from rvos_tpu_torch.models.layers import GCT

    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((3, 13, 17, 64)) + 1).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    gamma = rng.standard_normal(64).astype(np.float32)
    beta = rng.standard_normal(64).astype(np.float32)
    jx, tx = _bf16(x)
    jp = {n: _bf16(v.reshape(1, 1, 1, 64))[0]
          for n, v in (("alpha", alpha), ("gamma", gamma), ("beta", beta))}
    want = _np(jax.jit(lambda v, p: JGCT(64).apply(p, v))(jx, {"params": jp}))
    gct = GCT(64).bfloat16()
    for n, v in (("alpha", alpha), ("gamma", gamma), ("beta", beta)):
        getattr(gct, n).data = _bf16(v.reshape(1, 64, 1, 1))[1]
    with torch.no_grad():
        got = _np(_nhwc(gct(tx.permute(0, 3, 1, 2))))
        g32 = GCT(64)
        for n in ("alpha", "gamma", "beta"):
            getattr(g32, n).data = getattr(gct, n).data.float()
        f32 = _np(_nhwc(g32(tx.permute(0, 3, 1, 2).float()).bfloat16()))
    np.testing.assert_array_equal(got, want)
    assert (f32 != want).mean() > 1e-3


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_resize_bf16_matches_jax(mode):
    """The bf16 resize (bf16 matrices, float32 accumulation, bf16 after
    each axis) equals JAX's bit for bit, down and up; its gradient
    (``F.interpolate``-free: two matmuls) is within one bf16 ulp of
    JAX's.  ``F.interpolate`` in float32 on the same values parts from
    it (power)."""
    import jax
    import jax.numpy as jnp
    from rvos_tpu.ops.resize import resize_hw as jresize
    from rvos_tpu_torch.ops.resize import resize_nchw

    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((2, 13, 17, 5))).astype(np.float32)
    for out_hw in ((8, 10), (25, 31)):
        g = rng.standard_normal(out_hw + (2, 5)).astype(np.float32)
        jx, tx = _bf16(x.transpose(1, 2, 0, 3))              # [H, W, N, C]
        want, vjp = jax.vjp(lambda v: jresize(v, out_hw, mode), jx)
        jdx, = vjp(jnp.asarray(g).astype(jnp.bfloat16))
        tx = tx.permute(2, 3, 0, 1).contiguous().requires_grad_()
        got = resize_nchw(tx, out_hw, mode)
        got.backward(_bf16(g)[1].permute(2, 3, 0, 1))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got.permute(2, 3, 0, 1)),
                                      _np(want))
        ref = _np(jdx)
        err = np.abs(_np(tx.grad.permute(2, 3, 0, 1)) - ref).max()
        assert err <= 2 ** -8 * np.abs(ref).max(), err
        f32 = resize_nchw(tx.detach().float(), out_hw, mode)
        assert np.abs(_np(f32.permute(2, 3, 0, 1)) - _np(want)).max() > 1e-3


# --- the measuring tools of the bf16 route -----------------------------

def test_local_ties_report_counts_ties_and_the_first_winner_gap():
    """``cli.local_ties.tie_report`` on a cube with exact ties (small
    integer embeddings; measured: 8.1 % of the minima tied, 2.1 entries
    at a tied minimum): ties counted, and the first winner's gradient
    far from JAX's split that ``LocalMatchingMin`` returns (17.8 %)."""
    from rvos_tpu_torch.cli.local_ties import tie_report

    x, ys, lab, g = _local_case(True, (1, 3, 4), 1)
    r = tie_report(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(ys).bfloat16(), torch.from_numpy(lab),
                   (1, 3, 4), 1, torch.from_numpy(g))
    assert r["outputs"] > 0 and r["tied_share"] > 0.0, r
    assert r["mean_tied_entries"] >= 2 and r["all_rel_l2"] > 0.1, r


def test_profile_by_stage_names_the_bf16_route(one_thread):
    """``cli.profile_train``'s stage split of one bf16 ``loss_fn`` and
    backward on the CPU: the casts, GCT, convolutions and the local
    tie-split backward each get their operations, and the ranges are
    taken out again afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from rvos_tpu_torch.cli.profile_train import _spans, stage_breakdown
    from rvos_tpu_torch.engine import train as train_mod
    from rvos_tpu_torch.models.layers import GCT

    real = (train_mod.cast_state, GCT.forward)
    tr = Trainer(tiny_test(**dict(TRAIN_KW,
                                  TRAIN_COMPUTE_DTYPE="bfloat16")),
                 device="cpu", seed=0)
    batch = batch_to_device(train_batch(), torch.device("cpu"))
    with _spans(), profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = tr._step_fn.loss_fn(batch, STEP, step_key())
        loss.backward()
    assert (train_mod.cast_state, GCT.forward) == real
    stages = stage_breakdown(prof, device=False)
    for name in ("bf16 casts", "bwd bf16 casts", "GCT", "bwd GCT",
                 "convolution", "bwd convolution", "local matching",
                 "bwd local matching", "group norm"):
        assert stages.get(name, [0])[0] > 0, (name, stages)
