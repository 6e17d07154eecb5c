"""The port's eval CLI (``rvos_tpu_torch.cli.eval``) against the JAX
package's: flag handling, the round-robin shard split and reference
checkpoints given by ``--ckpt_path``.  Runs on the CPU at the
``tiny_test`` preset."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from rvos_tpu.cli import eval as jcli
from rvos_tpu.configs import get_config as j_get_config

from rvos_tpu_torch.cli import eval as tcli
from rvos_tpu_torch.configs import get_config
from rvos_tpu_torch.models import AOCNet
from rvos_tpu_torch.weights import init_random_
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

_ARGV = [
    [],
    ["--min_matching_pixels", "0"],
    ["--parity", "--mem_every", "3", "--ucr", "0.8"],
    ["--matching_dtype", "float32", "--eval_dtype", "float32",
     "--max_long_edge", "600", "--min_matching_pixels", "4096"],
    ["--float16", "--global_atrous_rate", "2", "--exp_name", "x"],
    ["--dataset", "davis2017", "--davis_root", "D", "--perturb", "3",
     "--all_labels", "--jf"],
    ["--ms", "1.0", "1.5", "--flip"],
]


@pytest.mark.parametrize("argv", _ARGV, ids=lambda a: " ".join(a) or "preset")
def test_apply_args_matches_jax(argv):
    """The flags both CLIs share give the same config (exact equality);
    ``--min_matching_pixels 0`` is the no-cap layout that runs B.3."""
    want = jcli.apply_args(j_get_config("resnet101_aocnet"),
                           jcli.build_parser().parse_args(argv))
    got = tcli.apply_args(get_config("resnet101_aocnet"),
                          tcli.build_parser().parse_args(argv))
    assert got.__dict__ == want.__dict__
    if "0" in argv:
        assert got.MATCHING_MAX_REF_PIXELS == 0


@pytest.mark.parametrize("n,shards", [(3, 2), (10, 3), (2, 4)])
def test_shard_view_splits_like_jax(n, shards):
    """Every sequence lands in exactly one shard, the same one as in the
    JAX CLI's ``_ShardView``."""
    ds = list(range(n))
    seen = []
    for sid in range(shards):
        got = tcli._ShardView(ds, sid, shards)
        want = jcli._ShardView(ds, sid, shards)
        assert [got[i] for i in range(len(got))] == [
            want[i] for i in range(len(want))]
        seen += [got[i] for i in range(len(got))]
    assert sorted(seen) == ds


def _run(tmp_path, name, *argv):
    out = str(tmp_path / name)
    tcli.main(["--synthetic", "--device", "cpu", "--config", "tiny_test",
               "--out", out, *argv])
    return {seq: {f: np.asarray(Image.open(os.path.join(out, seq, f)))
                  for f in sorted(os.listdir(os.path.join(out, seq)))}
            for seq in sorted(os.listdir(out))}


def test_cli_loads_reference_checkpoint(tmp_path):
    """``--ckpt_path`` with a reference-format ``.pth`` (wrapper,
    ``module.`` prefixes, ``num_batches_tracked``) gives the masks of
    the same weights made from ``--seed``, here at no cap (B.3) on one
    shard of three: only that shard's sequence is written."""
    cfg = get_config("tiny_test")
    sd = init_random_(AOCNet(cfg), torch.Generator().manual_seed(5)
                      ).state_dict()
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    ckpt["module.feature_extracter.backbone.bn1.num_batches_tracked"] = \
        torch.zeros((), dtype=torch.long)
    path = str(tmp_path / "aoc.pth.tar")
    torch.save({"state_dict": ckpt}, path)
    common = ("--min_matching_pixels", "0", "--shard_id", "2",
              "--shard_num", "3")
    loaded = _run(tmp_path, "loaded", "--ckpt_path", path, "--seed", "0",
                  *common)
    seeded = _run(tmp_path, "seeded", "--seed", "5", *common)
    other = _run(tmp_path, "other", "--seed", "0", *common)
    assert list(loaded) == list(seeded) == ["test3"]
    assert len(loaded["test3"]) == 9
    for f, mask in seeded["test3"].items():
        np.testing.assert_array_equal(loaded["test3"][f], mask)
    assert any((other["test3"][f] != m).any() for f, m in seeded["test3"].items())


def test_cli_refuses_what_it_cannot_run(tmp_path):
    """A checkpoint that does not load is an error, not random weights;
    a shard id outside the shard count exits."""
    with pytest.raises(FileNotFoundError):
        _run(tmp_path, "a", "--ckpt_path", str(tmp_path / "missing.pth"))
    with pytest.raises(SystemExit):
        _run(tmp_path, "b", "--shard_id", "2", "--shard_num", "2")


def test_cli_runs_the_ensemble(tmp_path, capsys):
    """``--flip --ms 1.0 0.8``: the multi-scale + flip ensemble writes a
    mask per frame of its shard, at the frames' size, and they differ
    from the single-scale run's."""
    common = ("--seed", "1", "--shard_id", "1", "--shard_num", "3")
    mf = _run(tmp_path, "mf", "--flip", "--ms", "1.0", "0.8", *common)
    single = _run(tmp_path, "single", *common)
    assert "Total FPS" in capsys.readouterr().out
    assert list(mf) == list(single) == ["test2"]
    assert len(mf["test2"]) == 9 and (tmp_path / "mf.zip").exists()
    for f, mask in mf["test2"].items():
        assert mask.shape == (129, 129)
    assert any((single["test2"][f] != m).any() for f, m in mf["test2"].items())


def test_train_cli_runs_on_the_cpu(tmp_path):
    """``python -m rvos_tpu_torch.cli.train --config tiny_test --synthetic
    --total_step 2 --device cpu``: an ``Itr:`` line with a finite loss
    for each step, two lines of the metrics log and the last step's
    checkpoint, which a new run of the same command resumes from (and so
    has nothing left to do)."""
    import json
    import re
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "rvos_tpu_torch.cli.train", "--config",
           "tiny_test", "--synthetic", "--total_step", "2", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    itr = re.findall(r"^Itr:(\d+), LR:([\d.]+), Time:[\d.]+, L:(\S+) "
                     r"IoU:(\S+)$", out.stdout, re.M)
    assert [int(i[0]) for i in itr] == [1, 2], out.stdout
    assert all(np.isfinite(float(i[2])) for i in itr)
    res = tmp_path / "workdir" / "result" / "tiny"
    lines = (res / "log" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(json.loads(x)["grad_norm"]) for x in lines)
    state = torch.load(res / "ckpt" / "save_step_2.pth", weights_only=True)
    assert state["step"] == 2 and state["optimizer"]["count"] == 2
    again = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=600)
    assert again.returncode == 0 and "Auto-resumed from step 2" in again.stdout
    assert "Itr:" not in again.stdout


@pytest.mark.parametrize("argv,error", [
    (["--float16", "--device", "cpu"], NotImplementedError),
    (["--gpu_num", "2", "--device", "cpu"], NotImplementedError),
    ([], RuntimeError),
])
def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, argv,
                                               error):
    """bfloat16 training and several GPUs are not ported; without
    ``--device cpu`` and without a card the CLI raises."""
    from rvos_tpu_torch.cli import train as train_cli
    if not argv and torch.cuda.is_available():
        pytest.skip("a card is visible")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error):
        train_cli.main(["--config", "tiny_test", "--synthetic",
                        "--total_step", "1", *argv])
