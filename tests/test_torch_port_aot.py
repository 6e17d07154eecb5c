"""AOT-L (``models/aot.py``) and its run through the port's evaluator,
against the benchmark's plain float32 reference
(``benchmark/reference/aot.py``), on the CPU in float32.

The network is AOT-L at its published widths (MobileNetV2 with its four
taps, three long/short-term blocks of d 256, the 15×15 window, the FPN
decoder) with 4 object channels, every parameter drawn at random,
biases, norms and the value biases of the local attention included, so
that every term moves the output.  The blocks run on a 17×21 token grid
(257×321 frames: the window meets the frame's edges and lies inside it),
whole videos on a 9×11 grid (129×161 frames).

Tolerances: port and reference are both float32 and differ only in the
order of their sums (the port's local attention is dense over the frame
with an offset table, the reference's unfolds the window; the port's
long-term attention is one masked product over the capacity, the
reference's a loop over heads): block outputs within 1e-4 of their
largest |value|, probabilities within 1e-4 (measured: a few 1e-6).
Chunked and frame-by-frame runs differ only in the batch of the encoder's
convolutions: masks equal on 99.9 % of pixels, as the AOC evaluator's
tests hold them, the final memories within 1e-4.
"""

import numpy as np
import pytest
import torch

from benchmark.drivers.eval_videos import _Seq
from benchmark.harness.videos import render
from benchmark.reference.aot import AOTRef, check_video
from benchmark.reference.video import Scores
from rvos_tpu_torch.configs import get_config
from rvos_tpu_torch.engine import Evaluator
from rvos_tpu_torch.models import build_model
from rvos_tpu_torch.models.mobilenet import MobileNetV2
from rvos_tpu_torch.ops.attention import memory_attention
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

HW = (129, 161)             # videos
N = 9 * 11                  # their tokens
HW_BLOCKS = (257, 321)      # the block test's frame, 17×21 tokens
FIELDS = dict(MODEL_MAX_OBJ_NUM=4, EVAL_COMPUTE_DTYPE="float32",
              TEST_MAX_SIZE=1040.0)
REF_KEYS = ("MODEL_MAX_OBJ_NUM", "MEM_EVERY", "TEST_MAX_SIZE")


def _cfg(**kw):
    return get_config("aotl_mobilenetv2", **{**FIELDS, **kw})


def _ref_cfg(cfg):
    return {k: getattr(cfg, k) for k in REF_KEYS}


def _model(cfg, seed=0):
    """AOT with every parameter random: weights N(0, 1/fan_in), biases
    and the value biases N(0, 0.1²), norm weights 1 + N(0, 0.1²)."""
    model = build_model(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2 and name.endswith("weight"):
                p.copy_(r / np.sqrt(np.prod(p.shape[1:])))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
    return model.eval()


@pytest.fixture(scope="module")
def net():
    cfg = _cfg()
    model = _model(cfg)
    return cfg, model, AOTRef(model.state_dict(), _ref_cfg(cfg))


def _video(n_frames=12, objs=2, seed=3):
    return render([n_frames, objs, [0] * objs], HW, seed, 0, "cpu", "v")


def _close(got, want, tol=1e-4):
    scale = want.abs().max().clamp(min=1.0)
    assert ((got - want).abs().max() / scale).item() <= tol


@torch.no_grad()
@pytest.mark.parametrize("memory", ["reference_pass", "two_frames"])
def test_blocks_match_reference(net, memory):
    """Every block's normed output, Q and u, in AOT's reference pass and
    over a memory of two written frames and a short-term frame."""
    cfg, model, ref = net
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 3) + HW_BLOCKS, generator=g)
    taps = model.encode(x)
    for a, b in zip(taps, ref.encode(x)):
        _close(a, b)
    lab = torch.randint(0, 3, HW_BLOCKS, generator=g)
    id_emb = model.id_embed(torch.nn.functional.one_hot(
        lab, 4).permute(2, 0, 1)[None].float())[0]
    _close(id_emb, ref.id_embed(lab))
    if memory == "reference_pass":
        got = model.lstt(taps[-1][0], id_emb=id_emb)
        want = ref.passes(ref.encode(x), id_emb=ref.id_embed(lab))
    else:
        n, d, L = 17 * 21, 256, 3
        mem = torch.randn((L, 3 * n, d), generator=g)
        memv = torch.randn((L, 3 * n, d), generator=g)
        st = (torch.randn((L, n, d), generator=g),
              torch.randn((L, n, d), generator=g))
        cu = torch.tensor([0, 2 * n], dtype=torch.int32)
        got = model.lstt(taps[-1][0], (mem, memv, cu), st)
        lt = [(mem[i, :2 * n], memv[i, :2 * n]) for i in range(L)]
        want = ref.passes(ref.encode(x), lt, [(st[0][i], st[1][i])
                                               for i in range(L)])
    for i in range(3):
        _close(got[0][i], want[0][i])
        _close(got[1][i], want[1][i])
        _close(got[2][i], want[2][i])


def test_memory_attention_ignores_capacity():
    """Rows past the valid length change nothing, whatever they hold."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn((40, 32), generator=g)
    k = torch.randn((120, 32), generator=g)
    v = torch.randn((120, 32), generator=g)
    cu = torch.tensor([0, 50], dtype=torch.int32)
    exact = memory_attention(q, k[:50], v[:50], cu, 4)
    for rows in (60, 120):
        kk, vv = k[:rows].clone(), v[:rows].clone()
        kk[50:] *= 1e3
        vv[50:] = -vv[50:] * 1e3
        # summation order only (zero weights past the length)
        torch.testing.assert_close(memory_attention(q, kk, vv, cu, 4), exact,
                                   rtol=1e-6, atol=1e-6)


def _run(cfg, model, video):
    ev = Evaluator(cfg, model, device="cpu")
    out = ev.evaluate_sequence(_Seq(video))
    masks = {int(k.split(".")[0]): v for k, v in out["results"].items()}
    return ev, masks


@torch.no_grad()
def test_video_matches_reference(net):
    """A 12-frame video through ``Evaluator.evaluate_sequence``: the long
    memory grows across two boundaries (frames 5 and 10); the reference,
    following the port's masks, finds every pixel's label its best."""
    cfg, model, _ = net
    video = _video()
    ev, masks = _run(cfg, model, video)
    st = ev._last_states[0]
    assert st.frames == 3 and sorted(masks) == list(range(1, 12))
    scores = Scores()
    check_video(model.state_dict(), _ref_cfg(cfg), video.frames,
                video.labels, masks, "cpu", scores)
    s = scores.summary()
    assert s["frames"] == 11 and s["gap_max"] <= 1e-4, s


@torch.no_grad()
def test_padded_capacity_equals_exact_memory(net, monkeypatch):
    """A capacity of one frame (grown twice, to four) and one of 16 give
    the port the same masks and the same memories."""
    from rvos_tpu_torch.engine.eval import _AOTState
    cfg, model, _ = net
    video = _video()
    runs = []
    for c in (1, 16):
        monkeypatch.setattr(_AOTState, "CAPACITY", c)
        runs.append(_run(cfg, model, video))
    (ev1, m1), (ev16, m16) = runs
    s1, s16 = ev1._last_states[0], ev16._last_states[0]
    assert (s1.capacity, s16.capacity) == (4, 16)
    for f in m1:
        np.testing.assert_array_equal(m1[f], m16[f])
    rows = s1.frames * s1.n
    # the masked attention of the CPU sums over the capacity, its blocks
    # split where the capacity puts them: the memories differ in the order
    # of their sums (on the card, bit for bit: test_torch_port_cuda.py)
    _close(s1.lt_v[:, :rows], s16.lt_v[:, :rows])
    assert s1.cu_k.tolist() == s16.cu_k.tolist() == [0, rows]


@torch.no_grad()
def test_chunk_step_equals_frame_by_frame(net):
    """Chunks of 5 through ``chunk_step`` against every frame alone."""
    cfg, model, _ = net
    video = _video(n_frames=11, objs=3, seed=5)
    ev5, m5 = _run(cfg, model, video)
    ev1, m1 = _run(cfg.replace(TEST_FRAME_CHUNK=1), model, video)
    assert ev5.chunk_n == 5 and ev1.chunk_n == 1
    for f in m5:
        assert (m5[f] == m1[f]).mean() >= 0.999
    a, b = ev5._last_states[0], ev1._last_states[0]
    for x, y in ((a.st_k, b.st_k), (a.st_v, b.st_v), (a.lt_v, b.lt_v)):
        _close(x, y)


def test_mobilenet_taps_leave_aocnet_tower_unchanged():
    """The tower with AOT's head has AOC-Net's tower's parameters plus
    the head's, computes the same features, and taps the same
    low-level block."""
    g = torch.Generator().manual_seed(4)
    aoc, aot = MobileNetV2(), MobileNetV2(last_channel=1280)
    sd = aoc.state_dict()
    assert not any(k.startswith("head.") for k in sd)
    assert set(aot.state_dict()) - set(sd) == {
        k for k in aot.state_dict() if k.startswith("head.")}
    with torch.no_grad():
        for p in aoc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    aot.load_state_dict(sd, strict=False)
    x = torch.randn((1, 3, 65, 97), generator=g)
    with torch.no_grad():
        feats, low = aoc(x)
        feats2, low2 = aot(x)
        taps = aot.taps(x)
    assert torch.equal(feats, feats2) and torch.equal(low, low2)
    assert torch.equal(taps[0], low)
    assert [t.shape[1] for t in taps] == [24, 32, 96, 1280]
    assert [t.shape[-1] for t in taps] == [25, 13, 7, 7]


@torch.no_grad()
def test_stage_marks_in_frame_order(net, monkeypatch):
    """AOT's stage marks (the calls recorded: the CPU launches none): a
    chunk's frames encoded together, then per frame the blocks, the
    decoder, the post-processing and the memory write; AOC-Net's matching
    and k-means stages never."""
    from rvos_tpu_torch.utils import trace
    cfg, model, _ = net
    stages = []
    monkeypatch.setattr(trace, "stage",
                        lambda name, device: stages.append(name))
    ev = Evaluator(cfg, model, device="cpu")
    ev.evaluate_sequence(_Seq(_video(n_frames=7)))
    assert set(stages) == set(trace.STAGES) - {"model.match", "model.kmeans"}
    frame = ["model.lstt", "model.decode", "pipeline.post", "pipeline.bank"]
    i = stages.index("model.decode") - 1
    assert stages[i - 1:i + 20] == ["model.extract"] + frame * 5
    assert stages.count("model.lstt") == 7


def test_eval_cli_runs_aotl(tmp_path, capsys):
    """``cli/eval.py --config aotl_mobilenetv2``: AOT-L at its published
    widths through the evaluator writes a mask per frame of its shard."""
    import os
    from rvos_tpu_torch.cli import eval as cli
    out = tmp_path / "aot"
    cli.main(["--synthetic", "--device", "cpu", "--config",
              "aotl_mobilenetv2", "--out", str(out), "--shard_id", "1",
              "--shard_num", "3"])
    assert "Total FPS" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["test2"]
    assert len(os.listdir(out / "test2")) == 9
