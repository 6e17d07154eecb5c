"""AOT's attentions (aot-benchmark ``networks/layers/attention.py``) in
stock PyTorch, over tokens ``[n, d]`` of one frame, ``heads`` heads of
``d / heads`` channels.  No hand-written kernel.

* ``memory_attention``: softmax(q·kᵀ/√dh)·v over the first ``cu_k[1]``
  rows of a preallocated memory ``k``, ``v`` [capacity, d]; ``cu_k`` is
  the int32 device tensor ``[0, valid rows]``, so one CUDA graph serves
  every memory length.  On a card in bf16/fp16 it is the flash kernel's
  variable-length form: the kernel reads the length from ``cu_k`` and
  stops there, and its result is the same, bit for bit, whatever the
  capacity.  Anywhere else (the CPU,
  float32) it is ``F.scaled_dot_product_attention`` over the whole
  capacity with the rows past the length masked out: their weights are
  exactly 0, so they add nothing, but they are computed.
* ``local_attention``: the short-term attention, each query over a
  (2·max_dis + 1)² window of the previous frame centred on its own
  position, with the learned relative biases on the logits (a grouped
  1×1 conv of the scaled query) and on the values; window positions
  outside the frame take no part.  Computed dense over the frame's
  tokens: the logits q·kᵀ in float32 over every key plus a bias that is
  the relative bias inside the window and -inf outside, gathered from a
  fixed offset table, a float32 softmax, the product with v, and the
  value biases over the window's weights.  At AOT-L's 31×54 grid that is
  two [8, 1674, 1674] products a layer, a few GFLOP; the window unfolded
  (the reference's form) moves ~0.4 GB a layer.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_CU_Q: Dict[Tuple, torch.Tensor] = {}


def _cu_q(n: int, device) -> torch.Tensor:
    """``[0, n]`` int32 on ``device``, made once (a CUDA graph's capture
    copies nothing from the host)."""
    key = (n, device)
    t = _CU_Q.get(key)
    if t is None:
        t = _CU_Q[key] = torch.tensor([0, n], dtype=torch.int32,
                                      device=device)
    return t


def heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[n, d] → [1, heads, n, d / heads]."""
    n, d = x.shape
    return x.view(n, heads, d // heads).transpose(0, 1)[None]


def full_attention(q, k, v, heads: int) -> torch.Tensor:
    """softmax(q·kᵀ/√dh)·v over every key: [n, d] each → [n, d]."""
    out = F.scaled_dot_product_attention(heads_first(q, heads),
                                         heads_first(k, heads),
                                         heads_first(v, heads))
    return out[0].transpose(0, 1).reshape(q.shape)


def memory_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cu_k: torch.Tensor, heads: int) -> torch.Tensor:
    """q [n, d] over the first ``cu_k[1]`` rows of k, v [capacity, d] →
    [n, d] (see the module)."""
    n, d = q.shape
    dh = d // heads
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        out = torch.ops.aten._flash_attention_forward(
            q.view(n, heads, dh), k.view(-1, heads, dh),
            v.view(-1, heads, dh), _cu_q(n, q.device), cu_k, n, k.shape[0],
            0.0, False, False, scale=dh ** -0.5)[0]
        return out.reshape(n, d)
    keep = torch.arange(k.shape[0], device=q.device) < cu_k[1]
    out = F.scaled_dot_product_attention(
        heads_first(q, heads), heads_first(k, heads), heads_first(v, heads),
        attn_mask=keep[None, None, None])
    return out[0].transpose(0, 1).reshape(n, d)


def _window_tables(h: int, w: int, max_dis: int):
    """For an h×w grid and a (2·max_dis + 1)² window: ``offset`` [n, n]
    int64, each key's window offset from each query (row-major, dy then
    dx) or the window's size where the key lies outside the window;
    ``key`` [n, W] int64, each query's key at each offset (0 where that
    lies outside the frame) and ``inside`` [n, W] bool."""
    win = 2 * max_dis + 1
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[None, :] - ys[:, None] + max_dis        # [query, key]
    dx = xs[None, :] - xs[:, None] + max_dis
    near = (dy >= 0) & (dy < win) & (dx >= 0) & (dx < win)
    offset = torch.where(near, dy * win + dx, torch.full_like(dy, win * win))
    oy = torch.arange(win).repeat_interleave(win) - max_dis
    ox = torch.arange(win).repeat(win) - max_dis
    ky = ys[:, None] + oy[None, :]
    kx = xs[:, None] + ox[None, :]
    inside = (ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)
    key = torch.where(inside, ky * w + kx, torch.zeros_like(ky))
    return offset, key, inside


_TABLES: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def window_tables(h: int, w: int, max_dis: int, device):
    """``_window_tables`` on ``device``, copied there once and kept."""
    key = (h, w, max_dis, device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = tuple(x.to(device)
                                 for x in _window_tables(h, w, max_dis))
    return t


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rel_k: torch.Tensor, rel_v: torch.Tensor, heads: int,
                    grid: Tuple[int, int], max_dis: int) -> torch.Tensor:
    """The short-term attention before its projection: q, k, v [n, d] on
    the ``grid`` (row-major), ``rel_k`` [heads, W, n] the logit biases of
    each query (W = (2·max_dis + 1)², computed from the scaled query),
    ``rel_v`` [heads, dh, W] the value biases → [n, d]."""
    n, d = q.shape
    dh = d // heads
    offset, key, inside = window_tables(grid[0], grid[1], max_dis, q.device)
    qh = q.float().view(n, heads, dh).transpose(0, 1) * dh ** -0.5
    kh = k.float().view(n, heads, dh).transpose(0, 1)
    bias = torch.cat([rel_k.float().transpose(1, 2),
                      rel_k.new_full((heads, n, 1), float("-inf"),
                                     dtype=torch.float32)], dim=2)
    bias = bias.gather(2, offset.expand(heads, n, n))
    attn = torch.softmax(torch.baddbmm(bias, qh, kh.transpose(1, 2)), dim=-1)
    vh = v.view(n, heads, dh).transpose(0, 1)
    out = torch.bmm(attn.to(v.dtype), vh)
    local = attn.gather(2, key.expand(heads, n, key.shape[1])) * inside
    out = out + torch.bmm(local.to(v.dtype), rel_v.transpose(1, 2).to(v.dtype))
    return out.transpose(0, 1).reshape(n, d)
