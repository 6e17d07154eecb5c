"""The whole slice: the port's streaming evaluator against the JAX
evaluator on the synthetic fixture, in parity mode on the CPU.

Both sides get the same weights (``from_jax_params``) and the same
frames; the only state JAX draws from its PRNG — the k-means init
scores, ``fold_in(PRNGKey(42), frame) → split(·, O) → uniform`` — is
reproduced on the JAX side and handed to the port through the
evaluator's ``kmeans_scores`` hook.  ``MEM_EVERY=2`` makes the bank
append twice in six frames.  A second case annotates a third object
from frame 3 on (a YouTube-VOS style mid-video object), which the
evaluators splice into the prediction and add to the bank.
"""

import json

import numpy as np
import pytest
import torch

from rvos_tpu.configs import tiny_test
from rvos_tpu.data.datasets import SyntheticEval
from rvos_tpu.engine.eval import Evaluator

import rvos_tpu_torch.configs as tconfigs
from rvos_tpu_torch.data import SyntheticEval as TSyntheticEval
from rvos_tpu_torch.engine import Evaluator as TEvaluator
from rvos_tpu_torch.models import AOCNet as TAOCNet
from rvos_tpu_torch.weights import init_random_
from torch_port_cases import (PIPE_KW, SIZE, jax_init, jax_kmeans_scores,
                              port_model_from_jax)
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

CFG_KW = dict(DATA_RANDOMCROP=SIZE, MODEL_MULTI_LOCAL_DISTANCE=(1, 2),
              MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None, TEST_BANK_CAPACITY=3,
              MEM_EVERY=2, TEST_FRAME_CHUNK=1)


def _new_object_label():
    lab = np.zeros(SIZE, np.uint8)
    lab[2:9, 20:31] = 3
    return lab


class _JoinAtFrame3:
    """The synthetic video with object 3 first annotated on frame 3."""

    def __init__(self, seq):
        self.seq = seq

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        sample = self.seq[idx]
        sample["meta"]["obj_num"] = 3
        if idx == 3:
            sample["current_label"] = _new_object_label()
        return sample


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """The JAX model and its own weights (made once a run: the pipeline's
    file asks for the same)."""
    from rvos_tpu.models import AOCNet

    cfg = tiny_test(**CFG_KW)
    return cfg, AOCNet(cfg), jax_init(tmp_path_factory, "pipe_init", PIPE_KW)


@pytest.fixture(scope="module", params=["first_frame_gt", "mid_video_gt"])
def both(request, jax_model):
    wrap = _JoinAtFrame3 if request.param == "mid_video_gt" else (lambda s: s)
    cfg, model, variables = jax_model
    seq = wrap(SyntheticEval(size=SIZE, n_seqs=1, n_frames=6)[0])
    want = Evaluator(cfg, model, variables).evaluate_sequence(seq)["results"]

    tcfg = tconfigs.tiny_test(**CFG_KW)
    ev = TEvaluator(tcfg, port_model_from_jax(tcfg, variables), device="cpu",
                    kmeans_scores=jax_kmeans_scores)
    tseq = wrap(TSyntheticEval(size=SIZE, n_seqs=1, n_frames=6)[0])
    got = ev.evaluate_sequence(tseq)
    return request.param, want, got


def test_evaluator_masks_match_jax(both):
    _, want, got = both
    assert sorted(got["results"]) == sorted(want) == [
        f"{i:05d}.jpg" for i in range(1, 6)]
    assert any(len(np.unique(m)) > 1 for m in want.values())
    for name, mask in want.items():
        g = got["results"][name]
        assert g.shape == mask.shape == SIZE and g.dtype == np.uint8
        agree = (g == mask).mean()
        assert agree >= 0.999, (name, agree)


def test_evaluator_outputs_label_set(both):
    kind, _, got = both
    assert got["frames"] == 5
    labels = {0, 1, 2} if kind == "first_frame_gt" else {0, 1, 2, 3}
    for mask in got["results"].values():
        assert set(np.unique(mask).tolist()) <= labels
    if kind == "mid_video_gt":
        new = _new_object_label() == 3
        assert (got["results"]["00003.jpg"][new] == 3).all()


# the bank layouts besides the default occupancy bank: a cap of 128 rows
# (of the 243 three 9×9 slots give) makes the fg-union compaction drop
# rows; the uniform layout fills 1024-row quotas
_LAYOUTS = {
    "cap0": dict(MATCHING_MAX_REF_PIXELS=0),
    "unsegmented": dict(MATCHING_MAX_REF_PIXELS=128,
                        MATCHING_SEGMENTED_BANK=False),
    "uniform": dict(MATCHING_MAX_REF_PIXELS=128, MATCHING_OCCUPANCY_BANK=False),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_evaluator_layouts_match_jax(layout, jax_model):
    """The evaluator under each other bank layout (no cap and the
    fg-union bank through B.3, the uniform-quota bank through B.2)
    against the JAX evaluator under the same layout: masks agree on ≥
    99.9 % of pixels per frame, and the k-means init scores cover every
    row of the compacted bank (all 243 at no cap)."""
    from rvos_tpu.models import AOCNet

    _, _, variables = jax_model
    kw = dict(CFG_KW, **_LAYOUTS[layout])
    cfg = tiny_test(**kw)
    seq = SyntheticEval(size=SIZE, n_seqs=1, n_frames=6)[0]
    want = Evaluator(cfg, AOCNet(cfg), variables).evaluate_sequence(seq)[
        "results"]

    tcfg = tconfigs.tiny_test(**kw)
    tmodel = port_model_from_jax(tcfg, variables)
    rows = []

    def scores(frame_idx, n_obj, n_rows):
        rows.append(n_rows)
        return jax_kmeans_scores(frame_idx, n_obj, n_rows)

    ev = TEvaluator(tcfg, tmodel, device="cpu", kmeans_scores=scores)
    got = ev.evaluate_sequence(TSyntheticEval(size=SIZE, n_seqs=1,
                                              n_frames=6)[0])["results"]
    assert rows == [{"cap0": 243, "unsegmented": 128, "uniform": 4096}[layout]
                    ] * 5
    assert sorted(got) == sorted(want)
    assert any(len(np.unique(m)) > 1 for m in want.values())
    for name, mask in want.items():
        agree = (got[name] == mask).mean()
        assert agree >= 0.999, (name, agree)


def test_lockstep_masks_on_one_device_agree_exactly():
    """``lockstep_masks`` with the CPU on both sides: every frame's
    repeat gives the very same logits, so the masks agree everywhere,
    and each bank compaction (frames 1 and 3) is repeated identically."""
    from rvos_tpu_torch.engine import eval as eval_mod
    from rvos_tpu_torch.engine.lockstep import lockstep_masks

    cfg = tconfigs.tiny_test(**CFG_KW)

    def scores(frame_idx, n_obj, n_rows):
        return torch.full((n_obj, n_rows), 0.75) + 1e-4 * torch.arange(n_rows)

    compact = eval_mod.precompact_bank
    res = lockstep_masks(
        cfg, lambda: init_random_(TAOCNet(cfg), torch.Generator().manual_seed(2)),
        TSyntheticEval(size=SIZE, n_seqs=1, n_frames=4)[0], scores,
        device="cpu")
    assert res.agree == [1.0, 1.0, 1.0]
    assert res.max_dlogit == res.max_demb == 0.0
    assert res.banks_equal == [True, True]
    assert res.unexplained == res.masks_parted == 0
    assert eval_mod.precompact_bank is compact


@pytest.mark.parametrize("share", [True, False], ids=["shared", "own"])
def test_lockstep_shares_the_decoder_masks(share):
    """The ensemble in lock-step on the CPU, the evaluator's saliency
    weights moved by 1e-5 of their size: some top-β mask entries part,
    each a near tie.  Where the reference goes on with the evaluator's
    masks, the logits stay within the gate; where it keeps its own, the
    parted entries move its logits past the gate's |Δlogit| bound."""
    from rvos_tpu_torch.engine.lockstep import (gate_failures, lockstep_masks,
                                                parity_config, parity_scores)
    from rvos_tpu_torch.models.layers import ConditioningLayer

    cfg = parity_config("occupancy").replace(
        TEST_FLIP=True, TEST_MULTISCALE=(1.0, 1.3))
    made = []

    def make_model():
        model = init_random_(TAOCNet(cfg), torch.Generator().manual_seed(0))
        if not made:
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for m in model.modules():
                    if isinstance(m, ConditioningLayer) and hasattr(
                            m, "phi_layer"):
                        w = m.phi_layer.weight
                        w += 1e-5 * w.abs().max() * torch.randn(
                            w.shape, generator=g)
        made.append(model)
        return model

    res = lockstep_masks(cfg, make_model,
                         TSyntheticEval(size=(65, 65), n_seqs=1,
                                        n_frames=6)[0],
                         parity_scores, device="cpu", share_masks=share)
    assert len(res.agree) == 20
    assert res.masks_parted > 0
    if share:
        assert res.unexplained == 0 and not gate_failures(res), res
    else:
        assert res.max_dlogit >= 1e-2, res


@pytest.mark.parametrize("layout", ["occupancy", "cap0"])
def test_whole_video_agreement_on_one_device_is_exact(layout):
    """``whole_video_agreement`` with the CPU on both sides, in the
    parity setting of the card checks: two runs agree on every pixel."""
    from rvos_tpu_torch.engine.lockstep import (parity_config, parity_scores,
                                                whole_video_agreement)

    cfg = parity_config(layout)
    agree = whole_video_agreement(
        cfg, lambda: init_random_(TAOCNet(cfg), torch.Generator().manual_seed(0)),
        lambda: TSyntheticEval(size=(65, 65), n_seqs=1, n_frames=4)[0],
        parity_scores, device="cpu")
    assert agree == [1.0, 1.0, 1.0]


def test_noise_sensitivity_cli_runs(capsys):
    """The noise experiment's script, on the CPU at 4 frames: no noise
    leaves every mask as it was; one JSON line per layout."""
    from rvos_tpu_torch.cli import noise_sensitivity

    noise_sensitivity.main(["--device", "cpu", "--eps", "0", "--seeds", "1",
                            "--frames", "4", "--layout", "uniform"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["layout"] == "uniform" and out["min_frame_agreement_per_seed"] == [1.0]


def test_lockstep_flips_cli_runs_on_cpu(capsys):
    """The lock-step diagnosis script with the CPU on both sides: one
    JSON line per frame, every pixel agreeing, no logit apart, then the
    run's summary."""
    from rvos_tpu_torch.cli import lockstep_flips

    lockstep_flips.main(["--device", "cpu", "--frames", "3",
                         "--layout", "uniform"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [ln["frame"] for ln in lines[:-1]] == [1, 2]
    for ln in lines[:-1]:
        assert ln["agree"] == 1.0 and ln["max_dlogit"] == 0.0
        assert "pixels" not in ln
    assert lines[-1]["agree"] == [1.0, 1.0] and lines[-1]["layout"] == "uniform"


def test_lockstep_flips_explains_a_parted_pixel():
    """``lockstep_flips.explain`` on a CPU lock-step frame whose first
    side is made to part at one pixel: the pixel is reported with both
    labels and margins, every recomputed variant (all on the CPU here)
    gives the CPU's label back, and kernel 2's recorded call matches its
    plain version exactly and float64 within float32 rounding."""
    from rvos_tpu_torch.cli.lockstep_flips import explain
    from rvos_tpu_torch.engine.lockstep import (lockstep_masks, parity_config,
                                                parity_scores)

    cfg = parity_config("occupancy")
    seen = []

    def on_frame(segment, args, ups):
        if seen:
            return
        got, want = (u.clone() for u in ups)
        b = int(want[:, 5, 7].argmax())
        a = (b + 1) % want.shape[0]
        got[a, 5, 7] = want[b, 5, 7] + 1.0
        seen.append((explain(segment, args, (got, want), "global_seg_map"),
                     a, b))

    lockstep_masks(cfg, lambda: init_random_(TAOCNet(cfg),
                                             torch.Generator().manual_seed(0)),
                   TSyntheticEval(size=(65, 65), n_seqs=1, n_frames=2)[0],
                   parity_scores, device="cpu", on_frame=on_frame)
    res, a, b = seen[0]
    assert res["agree"] == pytest.approx(1.0 - 1.0 / (65 * 65))
    (px,) = res["pixels"]
    assert px["pixel"] == [5, 7] and (px["card_label"], px["cpu_label"]) == (a, b)
    assert abs(px["margin_card"] - 1.0) < 1e-5 and px["margin_cpu"] <= 0
    for name in ("card_again", "kernel2_plain", "global_plain", "both_plain"):
        assert px[name] == dict(label=b, margin=px["margin_cpu"]), name
    k2 = res["kernel2"]
    assert k2["entries_differ"] == 0 and k2["card_vs_cpu"] == 0.0
    assert k2["card_vs_f64"] == k2["cpu_vs_f64"] < 1e-5
    assert k2["card_vs_f64_rms"] == k2["cpu_vs_f64_rms"] <= k2["cpu_vs_f64"]


def test_evaluator_requires_cuda_unless_cpu_requested():
    cfg = tconfigs.tiny_test(**CFG_KW)
    model = TAOCNet(cfg)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEvaluator(cfg, model)


def test_evaluator_bank_ring_and_default_scores():
    """Random seeded weights, the evaluator's own k-means draws: the bank
    pins slot 0 and rings over the others, appending every MEM_EVERY
    frames; two runs with the same seeds give the same masks."""
    cfg = tconfigs.tiny_test(**CFG_KW)
    runs = []
    for _ in range(2):
        model = init_random_(TAOCNet(cfg), torch.Generator().manual_seed(1))
        ev = TEvaluator(cfg, model, device="cpu")
        appended = []

        def log(f):
            appended.append(f)

        out = ev.evaluate_sequence(
            TSyntheticEval(size=SIZE, n_seqs=1, n_frames=6)[0],
            frame_callback=log)
        assert appended == list(range(6))
        st = ev._last_states[0]
        assert st.version == 3 and st.ring_ptr == 1     # frames 0, 2, 4
        assert st.slot_valid.tolist() == [1.0, 1.0, 1.0]
        assert set(st.ref_lab[1:].unique().tolist()) <= {0, 1, 2, 125}
        runs.append(out["results"])
    for name in runs[0]:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])
