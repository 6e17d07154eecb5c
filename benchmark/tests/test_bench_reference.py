"""The plain reference against the port's CPU path, at tiny sizes, and
the reference's imports."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness.manifest import ROOT
from benchmark.harness.weights import make_state
from benchmark.reference.aocnet import Ref, plain_precision
from benchmark.tests.tiny import passes, tiny_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "rvos_tpu", "rvos_tpu_torch")
REFERENCE_MODULES = ("benchmark.reference.aocnet", "benchmark.reference.bank",
                     "benchmark.reference.prng", "benchmark.reference.video")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("backbone", ["resnet", "mobilenet"])
def test_extract_feature_matches_port(backbone):
    from rvos_tpu_torch.configs import get_config
    from rvos_tpu_torch.models import AOCNet
    model = AOCNet(get_config("tiny_test", MODEL_BACKBONE=backbone)).eval()
    sd = make_state({n: t.shape for n, t in model.state_dict().items()}, 7,
                    "cpu")
    model.load_state_dict(sd)
    x = torch.randn((2, 65, 97, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), plain_precision():
        emb, low = model.extract_feature(x)
        r_emb, r_low = Ref(sd, backbone).extract_feature(x.permute(0, 3, 1, 2))
    torch.testing.assert_close(r_emb, emb.permute(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(r_low, low.permute(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_draws_match_port():
    from rvos_tpu_torch.ops.prng import kmeans_init_scores

    from benchmark.reference.prng import kmeans_scores
    want = kmeans_init_scores([0, 7, 2 ** 31 + 5], 3, 100)
    for i, f in enumerate([0, 7, 2 ** 31 + 5]):
        assert torch.equal(kmeans_scores(f, 3, 100, "cpu"), want[i])


def test_compaction_matches_port():
    from rvos_tpu_torch.ops.matching import compact_reference_bank_occupancy

    from benchmark.reference.bank import compact_occupancy
    g = torch.Generator().manual_seed(3)
    emb = torch.randn((3 * 900, 8), generator=g)
    lab = torch.nn.functional.one_hot(
        torch.randint(0, 4, (3 * 900,), generator=g), 5).float()
    lab[:500] = 0.0
    want_e, want_l, _ = compact_reference_bank_occupancy(emb, lab, 4096)
    got_e, got_l = compact_occupancy(emb, lab, 4096)
    assert torch.equal(got_e, want_e) and torch.equal(got_l, want_l)


@pytest.mark.parametrize("backbone", ["resnet", "mobilenet"])
def test_whole_videos_on_cpu_pass_the_check(backbone):
    """The port's evaluator on the CPU (float32) along three videos, one
    with a join, scored by the reference: within the limits."""
    from benchmark.drivers import eval_videos
    cell = tiny_cell(backbone, check_videos=3)
    res = eval_videos.run(cell, 2 ** 40 + 17, 1e9, False, device="cpu",
                          videos_limit=3, max_videos=3)
    assert res["check"]["frames"] == 11 + 8 + 6
    assert passes(res["check"], cell.limits), res["check"]


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, json\n"
            f"for m in {REFERENCE_MODULES!r}: __import__(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
