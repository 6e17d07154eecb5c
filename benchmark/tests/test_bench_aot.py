"""The AOT cell's check and FLOP count on the CPU: the correctness check
passes the port's own masks and fails planted faults (a dropped memory
frame, the short-term window shifted by four columns, the fp8 control);
the counted FLOPs of the blocks match a hand count.

The planted window fault is a shift by four columns.  Here a shift by
one column reads ``over_0.02`` 0.00011, two 0.00084, four 0.0031 (limit
0.001).  At the cell's own size on the card the bf16 program reads at
most 3.7e-5, one column 2.4e-7 to 0.0015 over eight seeds and two
columns 0.0014 and 0.0030: at random weights the 15×15 window's
attention is soft, one column of 15 moves it little, and on most seeds
the check cannot tell that fault from rounding.  A dropped memory frame
reads 2.1e-5 to 0.023 there over six seeds (this test's 0.054 is the
tiny size's)."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.counts import aot_flops
from benchmark.drivers import aot_videos
from benchmark.harness.manifest import Cell
from benchmark.reference.aocnet import fp8_cast
from benchmark.tests.tiny import passes

SEED = 2 ** 35 + 11
FIELDS = dict(MODEL_MAX_OBJ_NUM=4, EVAL_COMPUTE_DTYPE="float32",
              TEST_MAX_SIZE=1040.0)
VIDEOS = [[12, 3, [0, 0, 0]], [9, 2, [0, 4]]]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_cell():
    """``aotl.davis`` with 4 object channels, float32, on 256×320 videos
    (17×21 tokens: the 15×15 window meets the edges and lies inside), and
    the cell's limits."""
    from rvos_tpu_torch.configs import get_config
    real = Cell("aotl.davis")
    cfg = get_config("aotl_mobilenetv2", **FIELDS)
    conf = {}
    for k in real.config["config"]:
        v = getattr(cfg, k)
        conf[k] = list(v) if isinstance(v, tuple) else v
    return SimpleNamespace(
        name="tiny", chips=1,
        config={"preset": "aotl_mobilenetv2", "config": conf},
        mix={"driver": "aot_videos", "frame_hw": [256, 320], "videos": VIDEOS,
             "check_videos": 2},
        limits=real.limits)


def _run(control_cast=None):
    return aot_videos.run(tiny_cell(), SEED, 1e9, False, device="cpu",
                          videos_limit=2, max_videos=2,
                          control_cast=control_cast)


def test_port_masks_pass_and_control_fails():
    res = _run(fp8_cast)
    limits = tiny_cell().limits
    # float32 on both sides, apart in the order of their sums
    assert res["check"]["gap_max"] <= 1e-3, res["check"]
    assert passes(res["check"], limits), res["check"]
    assert not passes(res["control"], limits), res["control"]


def _drop_second(start, remember):
    """Each video's second long-term write (frame 5, or a join before
    it) is left out."""
    def run_start(self, k, v):
        self.writes = 0
        start(self, k, v)

    def run_remember(self):
        self.writes += 1
        if self.writes != 2:
            remember(self)
    return run_start, run_remember


def _shifted_tables(tables, columns=4):
    """The short-term window moved ``columns`` to the right: each key
    takes the window offset of the key that many columns to its left."""
    def run(h, w, max_dis, device):
        offset, key, inside = tables(h, w, max_dis, device)
        shift = torch.roll(torch.arange(h * w, device=device).view(h, w),
                           columns, dims=1).reshape(-1)
        return offset[:, shift], key, inside
    return run


def test_dropped_memory_frame_fails(monkeypatch):
    from rvos_tpu_torch.engine.eval import _AOTState
    run_start, run_remember = _drop_second(_AOTState.start,
                                           _AOTState.remember)
    monkeypatch.setattr(_AOTState, "start", run_start)
    monkeypatch.setattr(_AOTState, "remember", run_remember)
    res = _run()
    assert not passes(res["check"], tiny_cell().limits), res["check"]


def test_shifted_window_fails(monkeypatch):
    from rvos_tpu_torch.ops import attention
    monkeypatch.setattr(attention, "window_tables",
                        _shifted_tables(attention.window_tables))
    res = _run()
    assert not passes(res["check"], tiny_cell().limits), res["check"]


def test_block_flops_match_a_hand_count():
    """The blocks' products by formula on a 9×11 grid (n = 99 tokens, d
    256, FFN 1024, the 15×15 window) against the counted parts."""
    from rvos_tpu_torch.configs import get_config
    from rvos_tpu_torch.models import build_model
    cfg = get_config("aotl_mobilenetv2", **FIELDS)
    shapes = {k: t.shape for k, t in build_model(cfg).state_dict().items()}
    conf = tiny_cell().config["config"]
    parts = aot_flops.part_flops(shapes, conf, (129, 161))
    n, d, f, win, o, blocks = 99, 256, 1024, 225, 4, 3
    assert parts["grid"] == (9, 11)
    # per block: Q, K, V and projection of self-attention, linear_Q, the
    # two attention projections (8·n·d² in all) and their products; the
    # window's four products (relative_emb_k, q·k, the weights on v and
    # on relative_emb_v); the feed-forward's two linears and its
    # depthwise 5×5 conv
    block = (14 * n * d * d + 4 * n * n * d + 8 * n * win * d
             + 4 * n * d * f + 50 * n * f)
    assert parts["passes_0"] == blocks * block
    assert parts["per_memory_frame"] == blocks * 4 * n * n * d
    id_conv = 2 * n * d * o * 17 * 17
    assert parts["write"] == id_conv + blocks * 2 * n * d * d
    # frame 0: identities, a pass over its own memory (V from u + id)
    assert parts["reference"] == (id_conv + blocks * (
        block + 4 * n * n * d + 2 * n * d * d) + blocks * 2 * n * d * d)
    assert aot_flops.memory_frames(12, 5) == [1] * 5 + [2] * 5 + [3]
    assert aot_flops.memory_frames(9, 5, [4]) == [1] * 4 + [2, 3, 3, 3]
