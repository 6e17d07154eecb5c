"""The port's test datasets, perturbations and DAVIS metrics against the
JAX package's, and the eval CLI over a DAVIS- and a YouTube-VOS-layout
directory, on the CPU.

The fixtures are written with PIL: JPEG frames at 49×65 (on the grid the
evaluator keeps, so no resize), palette PNG annotations with the raw ids
{1, 13}.  In the DAVIS tree both objects are annotated on the first
frame; in the YouTube-VOS tree object 13 first appears on frame 2, with
an annotation of its own."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from rvos_tpu.data import datasets as jds
from rvos_tpu.data import perturb as jperturb
from rvos_tpu.utils import davis_metrics as jdm

from rvos_tpu_torch.cli import eval as tcli
from rvos_tpu_torch.data import datasets as tds
from rvos_tpu_torch.data import perturb as tperturb
from rvos_tpu_torch.utils import davis_metrics as tdm
from rvos_tpu_torch.utils.image import PALETTE
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

HW = (49, 65)
N_FRAMES = 6


def _png(path, lab):
    im = Image.fromarray(lab.astype(np.uint8), mode="P")
    im.putpalette(PALETTE)
    im.save(path)


def _frames(rng, n):
    base = rng.uniform(0, 255, HW + (3,))
    for i in range(n):
        img = np.roll(base, 3 * i, axis=1) * 0.8 + 20
        yield np.clip(img, 0, 255).astype(np.uint8)


def _label(i, with_13=True):
    lab = np.zeros(HW, np.uint8)
    lab[5:20, 4 + 2 * i:30 + 2 * i] = 1
    if with_13:
        lab[28:44, 35:60] = 13
    return lab


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    """DAVIS 2017 layout, one sequence of six frames, every frame
    annotated (the evaluator splices only the first)."""
    root = tmp_path_factory.mktemp("davis")
    img_dir = root / "JPEGImages" / "480p" / "blob"
    lab_dir = root / "Annotations" / "480p" / "blob"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("blob\n")
    for i, img in enumerate(_frames(np.random.default_rng(0), N_FRAMES)):
        Image.fromarray(img).save(img_dir / f"{i:05d}.jpg", quality=90)
        _png(lab_dir / f"{i:05d}.png", _label(i))
    return str(root)


@pytest.fixture(scope="module")
def ytb_root(tmp_path_factory):
    """YouTube-VOS layout: annotations on frames 0 (object 1) and 2
    (object 13 appears), ``meta.json`` listing the frames."""
    root = tmp_path_factory.mktemp("ytb")
    names = [f"{5 * i:05d}" for i in range(N_FRAMES)]
    img_dir = root / "JPEGImages" / "vid"
    lab_dir = root / "Annotations" / "vid"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    for i, img in enumerate(_frames(np.random.default_rng(1), N_FRAMES)):
        Image.fromarray(img).save(img_dir / f"{names[i]}.jpg", quality=90)
    _png(lab_dir / f"{names[0]}.png", _label(0, with_13=False))
    lab = np.zeros(HW, np.uint8)
    lab[28:44, 35:60] = 13
    _png(lab_dir / f"{names[2]}.png", lab)
    meta = {"videos": {"vid": {"objects": {
        "1": {"category": "x", "frames": names},
        "13": {"category": "y", "frames": names[2:]}}}}}
    (root / "meta.json").write_text(json.dumps(meta))
    return str(root)


def _same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _same_sequence(got, want):
    assert len(got) == len(want)
    assert got.seq_name == want.seq_name
    assert got.obj_nums == want.obj_nums and got.obj_lists == want.obj_lists
    assert got.label_convert == want.label_convert
    if want.label_backward is None:
        assert got.label_backward is None
    else:
        np.testing.assert_array_equal(got.label_backward, want.label_backward)
    for i in range(len(want)):
        _same_sample(got[i], want[i])


@pytest.mark.parametrize("all_labels", [False, True])
@pytest.mark.parametrize("perturb", [0, 3])
def test_davis_matches_jax(davis_root, all_labels, perturb):
    """Every sample of the port's ``DAVISTest`` equals the JAX package's:
    the frames (with a Gaussian-noise perturbation drawn from one seed),
    labels, ``current_label_all``, meta and the id remap of {1, 13}."""
    kw = dict(all_labels=all_labels, image_type=perturb, perturb_seed=7)
    want = jds.DAVISTest(davis_root, **kw)
    got = tds.DAVISTest(davis_root, **kw)
    assert got.seqs == want.seqs == ["blob"]
    seq, ref = got[0], want[0]
    _same_sequence(seq, ref)
    assert seq.label_convert == {1: 1, 13: 2}
    assert ("current_label_all" in seq[3]) == all_labels


@pytest.mark.parametrize("all_labels", [False, True])
def test_youtube_vos_matches_jax(ytb_root, tmp_path, all_labels):
    """``YTBVOSTest`` equals the JAX package's, object 13 joining on
    frame 2; both copy the first annotation into the result tree."""
    want = jds.YTBVOSTest(ytb_root, all_labels=all_labels,
                          result_root=str(tmp_path / "jax"))
    got = tds.YTBVOSTest(ytb_root, all_labels=all_labels,
                         result_root=str(tmp_path / "port"))
    assert got.seqs == want.seqs == ["vid"]
    seq = got[0]
    _same_sequence(seq, want[0])
    assert seq.obj_nums == [1, 1, 2, 2, 2, 2]
    assert "current_label" in seq[2] and "current_label" not in seq[1]
    assert sorted(os.listdir(tmp_path / "port" / "vid")) == ["00000.png"]


@pytest.mark.parametrize("image_type", range(10))
def test_perturbations_match_jax(image_type):
    """Types 0-9 from one seed give the JAX package's frames (its box
    blur is ``cv2.blur`` where cv2 is installed)."""
    img = np.random.default_rng(3).integers(0, 256, (37, 53, 3)).astype(
        np.float32)
    want = jperturb.get_perturbation(image_type,
                                     np.random.default_rng(11))(img)
    got = tperturb.get_perturbation(image_type,
                                    np.random.default_rng(11))(img)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _masks(seed, shape=(47, 61)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        m = np.zeros(shape, np.uint8)
        for oid in (1, 2):
            y, x = rng.integers(0, shape[0] - 10), rng.integers(0, shape[1] - 10)
            m[y:y + rng.integers(3, 15), x:x + rng.integers(3, 20)] = oid
        m[rng.random(shape) < 0.02] = rng.integers(0, 3)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_davis_metrics_match_jax(seed):
    """J, F (with its empty-contour cases) and mean J&F equal the JAX
    package's on random masks."""
    pred, gt = _masks(seed), _masks(seed + 10)
    gt[2][gt[2] == 2] = 0                         # object 2 absent once
    empty = np.zeros_like(gt[0])
    for p, g in list(zip(pred, gt)) + [(empty, empty), (pred[0], empty)]:
        for oid in (1, 2):
            assert tdm.jaccard(p == oid, g == oid) == jdm.jaccard(p == oid,
                                                                  g == oid)
            assert tdm.f_measure(p == oid, g == oid) == jdm.f_measure(
                p == oid, g == oid)
    got = tdm.evaluate_sequence(pred, gt, [1, 2])
    assert got == jdm.evaluate_sequence(pred, gt, [1, 2])
    assert tdm.mean_jf(got) == jdm.mean_jf(got)


def _pngs(root):
    return {os.path.join(seq, f): np.asarray(Image.open(os.path.join(
        root, seq, f)))
        for seq in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, seq))
        for f in sorted(os.listdir(os.path.join(root, seq)))}


def test_cli_davis_perturbed_with_jf(davis_root, tmp_path, capsys):
    """``--dataset davis --perturb 3 --all_labels --jf`` on the CPU: a PNG
    per frame after the first, in raw ids (no compact channel 2), J&F
    printed and equal to the JAX package's scoring of the same PNGs, the
    toolkit's CSVs and the zip written."""
    out = str(tmp_path / "Annotations")
    tcli.main(["--dataset", "davis", "--davis_root", davis_root,
               "--perturb", "3", "--all_labels", "--jf", "--device", "cpu",
               "--config", "tiny_test", "--out", out])
    printed = capsys.readouterr().out
    pngs = _pngs(out)
    assert sorted(pngs) == [f"blob/{i:05d}.png" for i in range(1, N_FRAMES)]
    ids = set(np.unique(np.concatenate([m.ravel() for m in pngs.values()])))
    assert ids <= {0, 1, 13} and 2 not in ids
    jf = jdm.evaluate_dataset_jf(out, os.path.join(davis_root, "Annotations",
                                                   "480p"))
    assert f"J&F: {jf['J&F']:.4f}" in printed
    assert os.path.exists(out + "_global_results.csv")
    assert os.path.exists(out + "_per-sequence_results.csv")
    assert os.path.exists(out + ".zip")


def test_cli_youtube_vos_restores_raw_ids(ytb_root, tmp_path):
    """The YouTube-VOS tree: object 13 is spliced on frame 2 and written
    back as id 13 where it was annotated; the first annotation is copied
    into the result tree."""
    out = str(tmp_path / "Annotations")
    tcli.main(["--dataset", "youtubevos_val", "--ytb_root", ytb_root,
               "--device", "cpu", "--config", "tiny_test", "--out", out])
    pngs = _pngs(out)
    assert sorted(pngs) == [f"vid/{5 * i:05d}.png" for i in range(N_FRAMES)]
    lab = np.asarray(Image.open(os.path.join(ytb_root, "Annotations", "vid",
                                             "00010.png")))
    assert (pngs["vid/00010.png"][lab == 13] == 13).all()
    ids = set(np.unique(np.concatenate([m.ravel() for m in pngs.values()])))
    assert ids <= {0, 1, 13}
