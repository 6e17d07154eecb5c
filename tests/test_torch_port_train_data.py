"""The port's training data against the JAX package's, on the CPU: the
transforms (``random_scale``, ``balanced_random_crop``,
``random_hflip``, ``normalize``) with the same generator,
``SyntheticTrain``, ``DAVISTrain`` and ``YTBVOSTrain`` over trees the
test writes with PIL (JPEG frames, palette PNG labels; several objects,
one appearing late) with seeds and epochs, and ``TrainBatcher``'s
batches through the train CLI's transform on loader threads.  Every
array must be equal (same dtype, same values)."""

import json

import numpy as np
import pytest
from PIL import Image

from rvos_tpu.cli import train as jcli
from rvos_tpu.configs import tiny_test as j_tiny
from rvos_tpu.data import datasets as jds
from rvos_tpu.data import transforms as jtr
from rvos_tpu.data.loader import TrainBatcher as JBatcher

from rvos_tpu_torch.cli import train as tcli
from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import datasets as tds
from rvos_tpu_torch.data import transforms as ttr
from rvos_tpu_torch.data.loader import TrainBatcher
from rvos_tpu_torch.utils.image import PALETTE
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

HW = (57, 77)
N_FRAMES = 9


def _assert_same(a, b, path="sample"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _label(i):
    lab = np.zeros(HW, np.uint8)
    lab[4:26, 3 + 2 * i:35 + 2 * i] = 1
    lab[30:52, 40:70] = 3
    if i >= 4:
        lab[10:24, 50:66] = 7
    return lab


def _write_seq(img_dir, lab_dir, names, rng):
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    for i, name in enumerate(names):
        img = rng.uniform(0, 255, HW + (3,)).astype(np.uint8)
        Image.fromarray(img).save(img_dir / f"{name}.jpg", quality=90)
        im = Image.fromarray(_label(i), mode="P")
        im.putpalette(PALETTE)
        im.save(lab_dir / f"{name}.png")


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis_train")
    rng = np.random.default_rng(0)
    for seq in ("a", "b"):
        _write_seq(root / "JPEGImages" / "480p" / seq,
                   root / "Annotations" / "480p" / seq,
                   [f"{i:05d}" for i in range(N_FRAMES)], rng)
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "train.txt").write_text("a\nb\n")
    return str(root)


@pytest.fixture(scope="module")
def ytb_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ytb_train")
    names = [f"{5 * i:05d}" for i in range(N_FRAMES)]
    _write_seq(root / "JPEGImages" / "v", root / "Annotations" / "v", names,
               np.random.default_rng(1))
    meta = {"videos": {"v": {"objects": {
        "1": {"frames": names}, "3": {"frames": names[:6]},
        "7": {"frames": names[4:5]}}}}}
    (root / "meta.json").write_text(json.dumps(meta))
    return str(root)


def _sample(seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(0, 255, HW + (3,)).astype(dtype)  # noqa: E731
    return {"ref_img": img(), "prev_img": img(),
            "curr_img": [img(), img()], "ref_label": _label(5),
            "prev_label": _label(2), "curr_label": [_label(3), _label(6)],
            "meta": {"obj_num": 7}}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_match_jax(seed, dtype):
    sample = _sample(seed, dtype)
    outs = []
    for tr in (jtr, ttr):
        rng = np.random.default_rng((seed, 9))
        s = tr.random_scale(sample, 60, 1.0, 1.3, rng)
        s = tr.balanced_random_crop(s, (49, 41), rng, 5, 2, 100)
        s = tr.random_hflip(s, 0.5, rng)
        s = dict(s, ref_img=tr.normalize(s["ref_img"]))
        outs.append((s, rng.integers(1 << 30)))
    _assert_same(outs[1], outs[0])


def test_synthetic_train_matches_jax():
    kw = dict(size=(33, 41), curr_len=3, length=5, obj_num=3, seed=4)
    a, b = jds.SyntheticTrain(**kw), tds.SyntheticTrain(**kw)
    assert len(a) == len(b)
    for i in range(len(a)):
        _assert_same(b[i], a[i])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_davis_train_matches_jax(davis_root, dtype):
    kw = dict(repeat_time=2, rand_gap=3, curr_len=3, seed=5,
              image_dtype=dtype)
    a = jds.DAVISTrain(davis_root, **kw)
    b = tds.DAVISTrain(davis_root, **kw)
    assert len(a) == len(b) == 4
    for epoch in (0, 2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in range(len(a)):
            _assert_same(b[i], a[i], f"epoch {epoch} item {i}")


def test_ytbvos_train_matches_jax(ytb_root):
    kw = dict(rand_gap=2, curr_len=2, seed=3, image_dtype=np.uint8)
    a = jds.YTBVOSTrain(ytb_root, **kw)
    b = tds.YTBVOSTrain(ytb_root, **kw)
    assert b.imglistdic == a.imglistdic
    for i in range(len(a)):
        _assert_same(b[i], a[i], f"item {i}")


def test_check_index_reflects_like_jax():
    for n in (1, 2, 7):
        for i in range(-12, 20):
            assert (tds.VOSTrain._check_index(n, i)
                    == jds.VOSTrain._check_index(None, n, i))


@pytest.mark.parametrize("synthetic", [True, False], ids=["synthetic", "davis"])
def test_train_batches_match_jax(davis_root, synthetic):
    """The train CLI's transform (DAVIS crops at 49×41 from frames of a
    60-pixel short edge scaled ×[1, 1.3]) over a seeded dataset, batched
    on two threads: two epochs of batches equal to the JAX package's,
    and an epoch entered at its second batch (a resumed run) equal to
    the rest of it."""
    kw = dict(DATA_RANDOMCROP=(49, 41), DATA_SHORT_EDGE_LEN=60,
              DATA_CURR_SEQ_LEN=2, DIR_DAVIS=davis_root,
              DATASETS=("davis2017",), DATA_DAVIS_REPEAT=3,
              DATA_MAX_OBJ_NUM=2)
    cfg, jcfg = tiny_test(**kw), j_tiny(**kw)
    if synthetic:
        jset = jds.SyntheticTrain(size=(33, 33), curr_len=2, length=5)
        tset = tds.SyntheticTrain(size=(33, 33), curr_len=2, length=5)
    else:
        jset = jds.DAVISTrain(davis_root, image_dtype=np.uint8, repeat_time=3,
                              curr_len=2, seed=11)
        tset = tds.DAVISTrain(davis_root, image_dtype=np.uint8,
                              repeat_time=3, curr_len=2, seed=11)
    jtf = _jax_transform(jcfg, synthetic)
    jb = JBatcher(jset, 2, jtf, seed=3, num_workers=2)
    tb = TrainBatcher(tset, 2, tcli.train_transform(cfg, synthetic), seed=3,
                      num_workers=2)
    for epoch in (0, 1):
        want = list(jb.epoch(epoch))
        got = list(tb.epoch(epoch))
        assert len(got) == len(want) > 0
        _assert_same(got, want, f"epoch {epoch}")
        assert got[0]["curr_img"].shape[:2] == (2, 2)
    skipped = list(tb.epoch(1, start=1))
    _assert_same(skipped, want[1:], "epoch 1 from its second batch")


def _jax_transform(cfg, synthetic):
    """The JAX train CLI's transform (a closure inside its ``main``)."""
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


def test_train_cli_args_match_jax():
    for argv in ([], ["--total_step", "6", "--lr", "0.02", "--batch_size",
                      "3", "--exp_name", "x", "--global_atrous_rate", "2"],
                 ["--datasets", "davis2017", "youtubevos", "--davis_root",
                  "D", "--ytb_root", "Y", "--start_step", "4",
                  "--pretrained_path", "p.pth", "--gpu_num", "1"]):
        want = jcli.apply_args(j_tiny(), jcli.build_parser().parse_args(argv))
        got = tcli.apply_args(tiny_test(), tcli.build_parser().parse_args(argv))
        assert got.__dict__ == want.__dict__, argv
