"""Operations and bytes of the port's hand-written kernels, from shapes.

Copied from the bring-up smoke's phase 2 arithmetic (``chip_smoke.py``
``check_occupancy``, ``check_local``, ``_bound_ms``), so that the yardstick
stays fixed while the program changes.  A kernel's least time on the card
is the larger of its bytes over the HBM rate and its operations over the
peak of the units that run them; its roofline share is that least time
over the measured time.  Peaks: NVIDIA's H100 SXM data sheet, dense,
at the card's full 700 W.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound_s(n_bytes: float, flops: float, kind: str, f32_ops: float = 0.0
            ) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[kind] + f32_ops / PEAK_FLOPS["f32"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def seg_map(m: int, p: int, c: int, o: int, mixed: bool = True
            ) -> Tuple[float, str]:
    """Global matching over the occupancy bank (B.1, ``seg_map`` kernel):
    M query rows against P bank rows of width C, O objects; the cross
    term 2·M·P·C at the operands' rate; bytes: both operands, the row
    biases, the output and the tile map, in float32."""
    n_bytes = (m * c + p * c + p + m * o) * 4 + (p // 1024) * 4
    return bound_s(n_bytes, 2.0 * m * p * c, "bf16" if mixed else "f32")


def window_pairs(h: int, w: int, radius: int, atrous: int = 1) -> int:
    """In-frame (pixel, offset) pairs of a (2·radius/atrous + 1)² window."""
    a = radius // atrous
    return sum(max(h - abs(dy) * atrous, 0) * max(w - abs(dx) * atrous, 0)
               for dy in range(-a, a + 1) for dx in range(-a, a + 1))


def local_match(h: int, w: int, c: int, o: int, radii: Sequence[int],
                s: int = 2, atrous: int = 1, mixed: bool = True
                ) -> Tuple[float, str]:
    """Local matching (B.4, ``local`` kernel) of one query on the h×w
    downsampled grid against S previous embeddings: the cross term
    2·S·C·pairs at the operands' rate and the epilogue's two mins per
    pair at the float32 rate; bytes: the query and S previous rows in
    the operands' type, the labels and the S·O·n_radii outputs."""
    elt = 2 if mixed else 4
    pairs = window_pairs(h, w, int(radii[-1]), atrous)
    n_bytes = ((1 + s) * h * w * c * elt + h * w * o * 4
               + s * h * w * o * len(radii) * 4)
    return bound_s(n_bytes, 2.0 * s * c * pairs, "bf16" if mixed else "f32",
                   f32_ops=2.0 * s * pairs)
