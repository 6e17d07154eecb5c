"""Inputs, oracles and checks that the port's CPU test files share.

A port test file takes what it shares with another from here, never
from another test file: each file then owns its fixtures, and which
file pays for which JAX reference stays visible.  JAX and the JAX
package are imported inside the functions that use them, so this module
imports where JAX is not installed.

* Training: the 33×33 step setting ``TRAIN_KW`` (two rollout frames,
  three object channels, radii 1 and 2, burn-in live at step ``STEP`` =
  5, hard mining mid-anneal, mixed matching, dropout 0, no remat),
  ``train_batch``, the step oracle ``compare_with_jax`` and the bf16
  routes' ``compare_route_with_jax``; the data pipeline's ``assert_same``
  and ``jax_transform``.
* Evaluation: ``SIZE``, JAX's k-means draws (``jax_kmeans_scores``);
  the multi-scale + flip ensemble setting ``MF_KW`` with ``run_both``,
  ``JoinObject2AtFrame3`` and its gates; the pipeline's ``PIPE_KW`` and
  the ``ChangingVideo``.
* ``jax_init``: the JAX model's own initialisation, made once in a test
  run for every file that asks for it (``once_per_run``), so that no two
  files build that JAX program.
"""

import fcntl
import os

import numpy as np
import torch

HW = (33, 33)
SIZE = (33, 33)


# ---- training -----------------------------------------------------------

STEP = 5
TRAIN_KW = dict(DATA_RANDOMCROP=HW, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
                MODEL_MAX_OBJ_NUM=3, DATA_CURR_SEQ_LEN=2,
                TRAIN_HARD_MINING_STEP=10, TRAIN_START_SEQ_TRAINING_STEPS=0,
                MODEL_ASPP_DROPOUT=0.0, TRAIN_REMAT=False, TEST_MAX_SIZE=None,
                TRAIN_AUTO_RESUME=False, MATCHING_DTYPE="mixed")


def train_batch(seed=0, t_len=2, b=1):
    """A clip of two objects (item 0) or one (items after it: object 2
    becomes background), some pixels ignored (255)."""
    rng = np.random.default_rng(seed)
    h, w = HW
    lab = np.zeros(HW, np.int32)
    lab[3:15, 2:14] = 1
    lab[18:30, 15:30] = 2
    lab[0, :6] = 255

    def item(a, i, dy, dx):
        a = np.roll(np.roll(a, dy + i, 0), dx - i, 1)
        return np.where(a == 2, 0, a) if i else a

    return {"ref_img": rng.standard_normal((b, h, w, 3)).astype(np.float32),
            "prev_img": rng.standard_normal((b, h, w, 3)).astype(np.float32),
            "curr_img": rng.standard_normal((t_len, b, h, w, 3)
                                            ).astype(np.float32),
            "ref_label": np.stack([item(lab, i, 0, 0) for i in range(b)]),
            "prev_label": np.stack([item(lab, i, 1, 1) for i in range(b)]),
            "curr_label": np.stack([np.stack([item(lab, i, 2 + t, 1 + t)
                                              for i in range(b)])
                                    for t in range(t_len)]),
            "obj_num": np.array([2] + [1] * (b - 1), np.int32)}


def step_key():
    """The port's k-means key of the first training step."""
    from rvos_tpu_torch.ops import prng
    return prng.next_step_key(prng.prng_key(prng.TRAIN_SEED))[1]


def jax_params(state):
    """A port model's state dict as the JAX package's parameter tree."""
    import jax.numpy as jnp

    from rvos_tpu.engine.checkpoint import _unflatten, convert_torch_statedict
    sd = {k: v.numpy() for k, v in state.items()}
    return _unflatten({k: jnp.asarray(v) for k, v in
                       convert_torch_statedict(sd).items()})


def compare_with_jax(kw=TRAIN_KW):
    """The JAX and port losses, IoUs and gradients of ``train_batch()``
    at ``kw`` (one jitted JAX value-and-grad of ``make_train_step(...)
    .loss_fn``), with the port's floor of every gradient
    (``engine.grad_check.floors``: three port runs with every weight
    scaled by 1 + 1e-6·N(0, 1))."""
    import jax
    import jax.numpy as jnp
    import optax

    from rvos_tpu.configs import tiny_test as j_tiny
    from rvos_tpu.engine.checkpoint import _flatten
    from rvos_tpu.engine.train import make_train_step
    from rvos_tpu.models.aocnet import AOCNet as JAOCNet
    from rvos_tpu_torch.configs import tiny_test
    from rvos_tpu_torch.engine.grad_check import floors, perturbed_state
    from rvos_tpu_torch.engine.train import Trainer
    from rvos_tpu_torch.weights import from_jax_params

    tr = Trainer(tiny_test(**kw), device="cpu", seed=0)
    params = jax_params(tr.model.state_dict())
    batch = train_batch()
    jkey = jax.random.split(jax.random.PRNGKey(1234))[1]
    step = make_train_step(j_tiny(**kw), JAOCNet(j_tiny(**kw)),
                           optax.sgd(0.1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: step.loss_fn(p, jb, jnp.asarray(STEP), jkey), has_aux=True))
    (_, (jlosses, jious, _)), jgrads = fn(params)
    jgrads = from_jax_params(_flatten(jax.device_get(jgrads)))

    key = step_key()
    assert np.array_equal(key.numpy(), np.asarray(jax.random.key_data(jkey))
                          if hasattr(jax.random, "key_data") else
                          np.asarray(jkey))
    # one thread: the port's side is then the same bit for bit on every
    # run (several threads' reductions are not, and a last-bit change
    # moves these gradients by percents)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, ious, grads = port_grads(tr, batch, key)
        names = [n for n, _ in tr.model.named_parameters()]
        state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        runs = []
        for seed in range(3):
            tr.model.load_state_dict(perturbed_state(state, names, seed))
            runs.append(port_grads(tr, batch, key)[2])
    finally:
        torch.set_num_threads(n_threads)
    return dict(jlosses=np.asarray(jlosses), jious=np.asarray(jious),
                jgrads=jgrads, losses=losses, ious=ious, grads=grads,
                floor=floors(grads, runs))


def port_grads(tr, batch, key):
    """The port's per-frame losses, IoUs and every parameter's gradient
    (zeros where none reaches it) of one ``loss_fn`` at ``STEP``."""
    from rvos_tpu_torch.engine.train import batch_to_device

    tr.optimizer.zero_grad()
    loss, (losses, ious, _) = tr._step_fn.loss_fn(
        batch_to_device(batch, torch.device("cpu")), STEP, key)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p))
             for n, p in tr.model.named_parameters()}
    return losses.detach().numpy(), ious.numpy(), grads


# the two bf16 training routes: bf16 compute (the forward on bf16 copies of
# the float32 parameters) and --float16 (float32 tower, bf16 matching)
BF16_ROUTES = {
    "compute": dict(TRAIN_COMPUTE_DTYPE="bfloat16"),
    "matching": dict(MATCHING_DTYPE="bfloat16"),
}


def compare_route_with_jax(route):
    """``compare_with_jax`` of a bf16 route, with the port's float32 step
    on the same weights (``f32_losses``, ``f32_grads``; one thread)."""
    from rvos_tpu_torch.configs import tiny_test
    from rvos_tpu_torch.engine.train import Trainer

    r = compare_with_jax(dict(TRAIN_KW, **BF16_ROUTES[route]))
    tr = Trainer(tiny_test(**TRAIN_KW), device="cpu", seed=0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r["f32_losses"], _, r["f32_grads"] = port_grads(tr, train_batch(),
                                                        step_key())
    finally:
        torch.set_num_threads(n)
    return r


def jax_gaps(r, grads, losses):
    """Per-frame relative loss gaps and the all-gradient relative L2 of a
    port step from the JAX step in ``r``."""
    from rvos_tpu_torch.engine.grad_check import gradient_failures

    want = {n: r["jgrads"][n] for n in grads}
    zero = dict.fromkeys(grads, 0.0)
    l2 = gradient_failures(grads, want, zero, 1.0)[1]["all_l2_rel"]
    rel = np.abs(losses - r["jlosses"]) / np.abs(r["jlosses"])
    return rel, l2


def assert_same(a, b, path="sample"):
    """Nested dicts, lists and arrays equal: same keys, lengths, dtypes,
    shapes and values."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def jax_transform(cfg, synthetic):
    """The JAX train CLI's transform (a closure inside its ``main``)."""
    from rvos_tpu.data import transforms as jtr

    def transform(sample, rng):
        if synthetic:
            out = dict(sample)
            out["ref_img"] = jtr.normalize(sample["ref_img"])
            out["prev_img"] = jtr.normalize(sample["prev_img"])
            out["curr_img"] = [jtr.normalize(x) for x in sample["curr_img"]]
            return out
        sample = jtr.random_scale(sample, cfg.DATA_SHORT_EDGE_LEN,
                                  cfg.DATA_MIN_SCALE_FACTOR,
                                  cfg.DATA_MAX_SCALE_FACTOR, rng)
        sample = jtr.balanced_random_crop(
            sample, cfg.DATA_RANDOMCROP, rng, cfg.DATA_MAX_CROP_STEPS,
            cfg.DATA_MAX_OBJ_NUM, cfg.DATA_MIN_OBJ_PIXEL_NUM)
        return dict(jtr.random_hflip(sample, cfg.DATA_RANDOMFLIP, rng))
    return transform


# ---- evaluation ---------------------------------------------------------

def jax_kmeans_scores(frame_idx, n_obj, n_rows):
    """The JAX evaluator's k-means init scores of a frame:
    ``fold_in(PRNGKey(42), frame) → split(·, O) → uniform(0.5, 1)``."""
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(42), np.int32(frame_idx))
    return np.stack([np.asarray(jax.random.uniform(k, (n_rows,), minval=0.5,
                                                   maxval=1.0))
                     for k in jax.random.split(key, n_obj)])


def port_model_from_jax(tcfg, variables):
    """The port's model at ``tcfg`` with the JAX variables' weights,
    loaded strictly."""
    import jax

    from rvos_tpu.engine.checkpoint import _flatten
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.weights import from_jax_params
    model = AOCNet(tcfg)
    model.load_state_dict(
        from_jax_params(_flatten(jax.device_get(variables["params"]))),
        strict=True)
    return model


# The multi-scale + flip ensemble ("MF", that of tests/test_eval_ensemble.py):
# radii (1, 2), 3 object channels, no size cap, TEST_FLIP and
# TEST_MULTISCALE=(1.0, 1.3) — four variants, 33×33 and 49×49 frames (9×9
# and 13×13 embeddings; an 0.8 scale would snap back to 33×33 and hide a
# mix-up of scales) — MEM_EVERY=2 and float32 matching (tiny_test's own:
# the JAX package's XLA global matching computes float32 even in mixed
# mode, while the port follows its Pallas kernels).  TEST_ENSEMBLE_SHARD
# is off: tests/conftest.py makes 8 virtual CPU devices, on which the JAX
# evaluator would otherwise shard the ensemble.
MF_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
             MODEL_MAX_OBJ_NUM=3, TEST_MAX_SIZE=None, TEST_FLIP=True,
             TEST_MULTISCALE=(1.0, 1.3), MEM_EVERY=2,
             TEST_ENSEMBLE_SHARD=False)


def once_per_run(tmp_path_factory, name, make):
    """``make()``, a flat dict of numpy arrays, computed once in a test
    run: the first process of the run that asks computes it and saves it
    in the run's temporary directory, which every pytest-xdist worker
    shares; the others wait on its lock and load it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            part = root / f"{name}.part.npz"
            np.savez(part, **{k.replace("/", ":"): v
                              for k, v in make().items()})
            part.rename(path)
    with np.load(path) as f:
        return {k.replace(":", "/"): f[k] for k in f.files}


def jax_init(tmp_path_factory, name, kw, size=SIZE):
    """The JAX model's own initialisation at ``tiny_test(**kw)``, made
    once in a test run (``once_per_run``) for every file that asks for
    it by ``name``."""
    import jax
    import jax.numpy as jnp

    from rvos_tpu.configs import tiny_test
    from rvos_tpu.engine.checkpoint import _flatten, _unflatten
    from rvos_tpu.models.aocnet import init_model

    def make():
        variables = init_model(tiny_test(**kw), jax.random.PRNGKey(0),
                               size)[1]
        return {k: np.asarray(v) for k, v in _flatten(variables).items()}
    flat = once_per_run(tmp_path_factory, name, make)
    return _unflatten({k: jnp.asarray(v) for k, v in flat.items()})


class JoinObject2AtFrame3:
    """The 6-frame synthetic video with object 2 left out of frame 0's
    annotation and first annotated on frame 3 (a YouTube-VOS style late
    object, spliced in and added to every variant's bank there)."""

    def __init__(self, seq):
        self.seq = seq

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        s = self.seq[idx]
        if idx == 0:
            s["current_label"][s["current_label"] == 2] = 0
        if idx == 3:
            lab = np.zeros(SIZE, np.uint8)
            lab[2:9, 20:31] = 2
            s["current_label"] = lab
        return s


def run_both(variables, n_frames=6, wrap=None, **kw):
    """The synthetic video (``wrap``-ped) through the JAX evaluator and the
    port's at ``MF_KW`` updated by ``kw``, both with the JAX ``variables``
    and each drawing its own default k-means scores → (JAX results, JAX
    states, port output, port evaluator)."""
    from rvos_tpu.configs import tiny_test
    from rvos_tpu.data.datasets import SyntheticEval
    from rvos_tpu.engine.eval import Evaluator
    from rvos_tpu.models.aocnet import AOCNet
    from rvos_tpu_torch import configs as tconfigs
    from rvos_tpu_torch.data import SyntheticEval as TSyntheticEval
    from rvos_tpu_torch.engine import Evaluator as TEvaluator

    wrap = wrap or (lambda s: s)
    cfg = tiny_test(**dict(MF_KW, **kw))
    jev = Evaluator(cfg, AOCNet(cfg), variables)
    want = jev.evaluate_sequence(wrap(SyntheticEval(
        size=SIZE, n_seqs=1, n_frames=n_frames)[0]))["results"]

    tcfg = tconfigs.tiny_test(**dict(MF_KW, **kw))
    ev = TEvaluator(tcfg, port_model_from_jax(tcfg, variables), device="cpu")
    got = ev.evaluate_sequence(wrap(TSyntheticEval(
        size=SIZE, n_seqs=1, n_frames=n_frames)[0]))
    return want, jev._last_states, got, ev


def assert_masks_agree(want, got, n_frames=6):
    """Every frame's masks agree on ≥ 99.9 % of pixels."""
    assert sorted(got) == sorted(want) == [f"{i:05d}.jpg"
                                           for i in range(1, n_frames)]
    assert any(len(np.unique(m)) > 1 for m in want.values())
    for name, mask in want.items():
        g = got[name]
        assert g.shape == mask.shape == SIZE and g.dtype == np.uint8, (
            name, g.shape, mask.shape, g.dtype)
        agree = (g == mask).mean()
        assert agree >= 0.999, (name, agree)


def assert_states_equal(jstates, tstates):
    """Each variant's state after the video: previous labels, bank slot
    validity, and the labels of every valid bank slot, equal; an
    ensemble's scales keep states of their own sizes."""
    assert len(jstates) == len(tstates)
    if len(tstates) > 1:
        assert len({tuple(st.prev_lab.shape) for st in tstates}) > 1
    for v, (js, ts) in enumerate(zip(jstates, tstates)):
        valid = np.asarray(js.slot_valid)
        np.testing.assert_array_equal(ts.slot_valid.numpy(), valid, str(v))
        np.testing.assert_array_equal(ts.prev_lab.numpy(),
                                      np.asarray(js.prev_lab), str(v))
        lab = np.asarray(js.ref_lab)[valid > 0]
        np.testing.assert_array_equal(ts.ref_lab.numpy()[valid > 0], lab,
                                      str(v))


# The streaming pipeline's setting: tiny_test at 33×33, radii (1, 2), four
# object channels, three bank slots, MEM_EVERY=3.  jax_init(..., "pipe_init",
# PIPE_KW) is also the weights of tests/test_torch_port_eval.py's setting,
# which differs in MEM_EVERY and TEST_FRAME_CHUNK only: the JAX package's
# initialisation is the same program for both, and gives the same arrays.
PIPE_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
               MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None, TEST_BANK_CAPACITY=3,
               MEM_EVERY=3)


class ChangingVideo:
    """A 13-frame synthetic video, obj_num 3, with only object 1 annotated
    on frame 0: object 3 is spliced in on frame 4 (a join frame), and
    object 2 appears in ``current_label_all`` from frame 8 on, so
    ``exist_mask`` changes inside the chunk of frames 7-9.  ``dataset``
    is the port's ``SyntheticEval`` or the JAX package's."""

    def __init__(self, dataset=None):
        if dataset is None:
            from rvos_tpu_torch.data import SyntheticEval as dataset
        self.seq = dataset(size=SIZE, n_seqs=1, n_frames=13)[0]
        self.seq_name = "changing"

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        s = self.seq[idx]
        s["meta"]["obj_num"] = 3
        if idx == 0:
            s["current_label"][s["current_label"] == 2] = 0
        if idx == 4:
            lab = np.zeros(SIZE, np.uint8)
            lab[2:9, 20:31] = 3
            s["current_label"] = lab
        if idx >= 8:
            lab = np.zeros(SIZE, np.uint8)
            lab[20:28, 4:12] = 2
            s["current_label_all"] = lab
        return s
