"""The port's training step against the JAX package's, and the trainer's
own guarantees, on the CPU.

Against JAX (one jitted ``value_and_grad`` of ``make_train_step(...)
.loss_fn``, computed once for the module): the tiny config at 33×33
(two rollout frames, three object channels, radii 1 and 2), the port's
seeded random weights carried to the JAX package through
``convert_torch_statedict``, the burn-in branch live (step 5 >
``TRAIN_START_SEQ_TRAINING_STEPS`` = 0: frame 1 reads frame 0's
prediction), hard mining mid-anneal (step 5 of 10: k = 57.5 %), mixed
matching (training's global and local distances stay float32; k-means
rounds to bf16), the k-means draws of the JAX trainer's key for that
step, dropout 0, no remat on the JAX side (compile time).

Tolerances.  Per-frame losses within 1e-5 relative (the bar
``ROADMAP.md`` names, ``test_torch_train_parity.py``'s, is 1e-3); IoUs
equal.  Every parameter tensor's gradient within 2e-2 of that tensor's
largest |g| (that test's bar, there on four tensors), or within three
times the port's own floor where the floor is larger
(``engine.grad_check``: the largest change of that gradient over three
port runs with every weight scaled by 1 + 1e-6·N(0, 1), about ten
ulps).  At this size rounding-sized changes of the weights move single
gradient tensors by percents, as ReLU inputs and argmins near their
kinks flip; 42 of 378 tensors part from JAX by more than 2e-2, each
within its floor (the summary printed with ``-s``).  All gradients
together within 2e-2 relative L2.

Port only: three steps of ``fit`` equal two steps, a checkpoint, an
automatic resume and one more step; remat equals no remat with dropout
on; a NaN batch leaves the parameters and the update count unchanged
while the step counter advances; the training route calls none of the
kernel wrappers.
"""

import os

import numpy as np
import pytest
import torch

from torch_port_threads import torch_threads  # noqa: F401 (autouse)

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import SyntheticTrain, TrainBatcher
from rvos_tpu_torch.engine.checkpoint import (list_checkpoint_steps,
                                              load_pretrained)
from rvos_tpu_torch.engine.grad_check import gradient_failures, update_check
from rvos_tpu_torch.engine.train import Trainer, batch_to_device
from torch_port_cases import (HW, STEP, TRAIN_KW, compare_with_jax, step_key,
                              train_batch)

GROUPS = ("feature_extracter.backbone", "feature_extracter.aspp",
          "feature_extracter.decoder", "semantic_embedding",
          "dynamic_prehead", "dynamic_seghead", "bias")


def _group(name):
    return next((g for g in GROUPS if name.startswith(g)), "bias")


@pytest.fixture(scope="module")
def against_jax():
    return compare_with_jax()


def test_loss_fn_losses_match_jax(against_jax):
    r = against_jax
    rel = np.abs(r["losses"] - r["jlosses"]) / np.abs(r["jlosses"])
    assert rel.max() <= 1e-5, (r["losses"], r["jlosses"])
    np.testing.assert_array_equal(r["ious"], r["jious"])


@pytest.mark.parametrize("group", GROUPS)
def test_loss_fn_gradients_match_jax(against_jax, group):
    r = against_jax
    names = [n for n in r["grads"] if _group(n) == group]
    assert names
    got = {n: r["grads"][n] for n in names}
    want = {n: r["jgrads"][n] for n in names}
    assert all(got[n].shape == want[n].shape for n in names)
    assert max(float(w.abs().max()) for w in want.values()) > 0, group
    bad, summary = gradient_failures(got, want, r["floor"], 2e-2)
    print(group, summary)
    assert not bad, bad


def test_all_gradients_match_jax(against_jax):
    """All parameters together; the frozen batch norms (parameters in
    JAX, buffers in the port) get no gradient in JAX either."""
    r = against_jax
    frozen = set(r["jgrads"]) - set(r["grads"])
    assert frozen and all(k.rsplit(".", 1)[-1] in ("weight", "bias",
                                                   "running_mean",
                                                   "running_var")
                          for k in frozen)
    assert all(float(r["jgrads"][k].abs().max()) == 0.0 for k in frozen)
    want = {n: r["jgrads"][n] for n in r["grads"]}
    bad, summary = gradient_failures(r["grads"], want, r["floor"], 2e-2)
    print(summary)
    assert not bad, bad
    assert summary["all_l2_rel"] <= 2e-2, summary


def _fit(cfg, steps, seed=0, **kw):
    data = SyntheticTrain(size=HW, curr_len=cfg.DATA_CURR_SEQ_LEN, length=8)
    from rvos_tpu_torch.cli.train import train_transform
    batcher = TrainBatcher(data, cfg.TRAIN_BATCH_SIZE,
                           train_transform(cfg, True), num_workers=1)
    tr = Trainer(cfg, device="cpu", seed=seed)
    return tr.fit(batcher, log_every=1, max_steps=steps, **kw)


def _params(tr):
    return {n: p.detach().clone() for n, p in tr.model.named_parameters()}


@pytest.fixture
def one_thread():
    """Torch's CPU reductions on several threads are not bit for bit
    repeatable (two runs of the same step part at 1e-8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fit_resumes_where_it_stopped(tmp_path, one_thread):
    """fit(3) == fit(2), checkpoint, a new trainer that resumes from it
    by itself, fit(3): parameters, momentum buffers and update count
    equal bit for bit (dropout on: its generator's state is restored)."""
    base = dict(TRAIN_KW, TRAIN_TOTAL_STEPS=3,
                TRAIN_START_SEQ_TRAINING_STEPS=1,
                TRAIN_HARD_MINING_STEP=2, TRAIN_AUTO_RESUME=True,
                MODEL_ASPP_DROPOUT=0.1)
    one = tiny_test(**base, DIR_ROOT=str(tmp_path / "one"))
    whole = _fit(one, 3)
    two = tiny_test(**base, DIR_ROOT=str(tmp_path / "two"))
    ckpt = two.result_dirs()["ckpt"]
    _fit(two, 2, save_every=2, ckpt_dir=ckpt)
    assert list_checkpoint_steps(ckpt) == [2]
    resumed = _fit(two, 3)
    assert resumed.step == whole.step == 3
    assert resumed.optimizer.count == whole.optimizer.count == 3
    got = _params(resumed)
    for n, p in _params(whole).items():
        torch.testing.assert_close(got[n], p, rtol=0, atol=0, msg=n)
    a = whole.optimizer.sgd.state_dict()["state"]
    b = resumed.optimizer.sgd.state_dict()["state"]
    for k in a:
        torch.testing.assert_close(b[k]["momentum_buffer"],
                                   a[k]["momentum_buffer"], rtol=0, atol=0)
    log = os.path.join(two.result_dirs()["log"], "metrics.jsonl")
    assert len(open(log).read().splitlines()) == 3


def test_remat_equals_no_remat_with_dropout(one_thread):
    """Remat recomputes each extraction and frame in the backward pass;
    the dropout masks come from seeds drawn outside, so the gradients
    equal those without remat.  On one thread, so that the recomputed
    forward is the same bit for bit (on several, a last-bit difference
    moves the gradients of this random network by percents)."""
    grads = []
    for remat in (False, True):
        cfg = tiny_test(**dict(TRAIN_KW, TRAIN_REMAT=remat,
                               MODEL_ASPP_DROPOUT=0.3))
        tr = Trainer(cfg, device="cpu", seed=1)
        key = step_key()
        loss, _ = tr._step_fn.loss_fn(
            batch_to_device(train_batch(2), torch.device("cpu")), STEP, key,
            [11, 12, 13])
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-7, msg=n)


def test_dropout_draws_from_its_generator():
    """With dropout on, two seeds give two masks and one seed the same;
    without a generator the extraction is deterministic."""
    cfg = tiny_test(**dict(TRAIN_KW, MODEL_ASPP_DROPOUT=0.5))
    tr = Trainer(cfg, device="cpu", seed=0)
    x = torch.from_numpy(train_batch()["ref_img"])

    def emb(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tr.model.extract_feature(x, gen)[0]

    assert torch.equal(emb(3), emb(3))
    assert not torch.equal(emb(3), emb(4))
    assert torch.equal(emb(None), emb(None))


def test_nonfinite_batch_is_skipped():
    cfg = tiny_test(**TRAIN_KW)
    tr = Trainer(cfg, device="cpu", seed=0)
    before = _params(tr)
    batch = train_batch()
    batch["curr_img"][0, 0, 5, 5, 0] = np.nan
    key = step_key()
    m = tr.train_step(batch, key)
    assert not np.isfinite(float(m["grad_norm"]))
    assert m["applied"] is False
    assert tr.step == 1 and tr.optimizer.count == 0
    for n, p in _params(tr).items():
        assert torch.equal(p, before[n]), n
    m = tr.train_step(train_batch(1), key)
    assert m["applied"] is True and tr.optimizer.count == 1


def test_update_check_holds_one_update_and_catches_its_controls():
    """``update_check`` between two CPU trainers, from a state with
    momentum buffers and an update count (two clipped updates of seeded
    gradients): the updates are equal bit for bit and leave the
    reference's state where it was; the card-side controls (no update,
    1.01 times the learning rate) are caught on most tensors."""
    cfg = tiny_test(**TRAIN_KW)
    ref = Trainer(cfg, device="cpu", seed=0)
    other = Trainer(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(4)
    names = [n for n, _ in ref.model.named_parameters()]
    for _ in range(2):
        for n, p in ref.model.named_parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        ref.optimizer.step()
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in ref.model.named_parameters()}
    del grads[names[0]]                   # a missing gradient counts as 0
    r = update_check(other, ref, grads)
    assert r["failures"] == [] and r["worst_rel"] == 0.0, r
    assert r["tensors"] == len(names)
    assert r["no_update"] > len(names) // 2, r
    assert r["lr_1.01"] > len(names) // 2, r
    assert ref.optimizer.count == other.optimizer.count == 3
    got = _params(other)
    for n, p in _params(ref).items():
        assert torch.equal(got[n], p), n

def test_training_route_calls_no_kernel(monkeypatch):
    """Kernels 1–4 have no backward: the training route never calls
    their wrappers, on any device."""
    from rvos_tpu_torch.ops import cuda_flat, cuda_local, cuda_matching, matching

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called in training")

    for mod, names in ((cuda_flat, ["global_flat_min"]),
                       (cuda_local, ["local_match"]),
                       (cuda_matching, ["global_seg_map", "global_seg"]),
                       (matching, ["global_flat_min", "local_match",
                                   "global_seg_map", "global_seg"])):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    tr = Trainer(tiny_test(**TRAIN_KW), device="cpu", seed=0)
    key = step_key()
    m = tr.train_step(train_batch(), key)
    assert np.isfinite(float(m["loss"])) and m["applied"] is True


def test_trainer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_test(**TRAIN_KW))


def test_load_pretrained_backbone_only(tmp_path):
    """A backbone-only reference file lands under ``feature_extracter``;
    keys that do not fit are reported, not loaded."""
    src = Trainer(tiny_test(**TRAIN_KW), device="cpu", seed=5).model
    sd = {k[len("feature_extracter."):]: v for k, v in
          src.state_dict().items() if k.startswith("feature_extracter.")}
    sd["aspp.conv1.weight"] = torch.zeros(3, 3)
    sd["not_a_key"] = torch.zeros(1)
    path = str(tmp_path / "backbone.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    dst = Trainer(tiny_test(**TRAIN_KW), device="cpu", seed=6).model
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    removed, n = load_pretrained(dst, path, full=False)
    assert n == len(sd)
    assert sorted(removed) == ["feature_extracter.aspp.conv1.weight",
                               "feature_extracter.not_a_key"]
    got = dst.state_dict()
    for k, v in src.state_dict().items():
        if k == "feature_extracter.aspp.conv1.weight" or not k.startswith(
                "feature_extracter."):
            assert torch.equal(got[k], before[k]), k
        else:
            assert torch.equal(got[k], v), k


def test_image_log_writes_the_overlays(tmp_path):
    """``TRAIN_IMG_LOG``: each logged step writes the reference, previous,
    ground-truth and prediction overlays of batch item 0."""
    cfg = tiny_test(**dict(TRAIN_KW, TRAIN_IMG_LOG=True, TRAIN_TOTAL_STEPS=1,
                           DIR_ROOT=str(tmp_path)))
    _fit(cfg, 1)
    img_dir = os.path.join(cfg.result_dirs()["log"], "images")
    assert sorted(os.listdir(img_dir)) == [
        f"000001_{n}.jpeg" for n in ("groundtruth", "prediction", "prev_img",
                                     "ref_img")]
