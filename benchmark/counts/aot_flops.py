"""AOT's FLOPs per frame, counted by the benchmark, each frame at its
own long-term memory's length.

The parts are counted by ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference (``reference/aot.py``) run on meta tensors
(shapes only, nothing computed; a multiply-add is 2 FLOPs): the encoder
and projector (``encode``), the blocks over a memory of m frames
(``passes``, linear in m: ``passes_0`` + m·``per_memory_frame``), the
decoder (``decode``), a frame's memory write (``write``: its identity
embedding and the value projections) and frame 0's reference pass
(``reference``, its identities and write included).  The local
attention counts the window's products alone (the port computes its
logits and weighted sum densely over the frame: the FLOPs here are the
model's, not the port's).  All ``MODEL_MAX_OBJ_NUM`` identity channels
count: AOT's identity bank and decoder have that width whatever the
video's objects.  Frame t > 0 attends the frames written before it:
frame 0, every ``MEM_EVERY``-th frame and each join frame
(``memory_frames``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from ..reference.aot import AOTRef


def _meta_state(shapes: Dict[str, torch.Size]) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(tuple(s), device="meta") for n, s in shapes.items()}


def _count(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return float(fc.get_total_flops()), out


def part_flops(shapes: Dict[str, torch.Size], cfg: Dict, hw) -> Dict:
    """The parts (see the module) at input size ``hw`` (the
    eval-resized frame), and the token ``grid``."""
    ref = AOTRef(_meta_state(shapes), cfg)
    x = torch.empty((1, 3, hw[0], hw[1]), device="meta")
    lab = torch.zeros(hw, dtype=torch.long, device="meta")
    encode, taps = _count(lambda: ref.encode(x))
    grid = tuple(taps[3].shape[-2:])
    reference, writes = _count(lambda: ref.reference(taps, lab))

    def passes(m):
        lt = [(torch.cat([k] * m), torch.cat([v] * m)) for k, v in writes]
        return _count(lambda: ref.passes(taps, lt, writes))

    one, (outs, qs, us) = passes(1)
    two, _ = passes(2)
    decode, _ = _count(lambda: ref.decode(taps, outs, grid))
    write, _ = _count(lambda: ref.write(qs, us, ref.id_embed(lab)))
    return {"encode": encode, "passes_0": 2 * one - two,
            "per_memory_frame": two - one, "decode": decode, "write": write,
            "reference": reference, "grid": grid}


def memory_frames(t_len: int, gap: int, joins: Iterable[int] = ()
                  ) -> List[int]:
    """For frames 1 … t_len - 1, the frames in the long-term memory when
    each runs."""
    joins = set(joins)
    out, m = [], 1
    for t in range(1, t_len):
        out.append(m)
        if t in joins or (gap > 0 and t % gap == 0):
            m += 1
    return out


def frame_flops(parts: Dict, m: int) -> float:
    """A frame after frame 0 over a memory of ``m`` frames."""
    return (parts["encode"] + parts["passes_0"] + m * parts["per_memory_frame"]
            + parts["decode"] + parts["write"])


def video_flops(parts: Dict, t_len: int, gap: int, joins: Iterable[int] = ()
                ) -> Dict[str, float]:
    """{"frame0": frame 0, "frame": the mean of every later frame}."""
    ms = memory_frames(t_len, gap, joins)
    mean = sum(frame_flops(parts, m) for m in ms) / max(len(ms), 1)
    return {"frame0": parts["encode"] + parts["reference"], "frame": mean}
