"""AOT-L: Associating Objects with Transformers (Yang, Wei and Yang,
NeurIPS 2021; aot-benchmark ``networks/models/aot.py``,
``networks/layers/transformer.py``, ``networks/layers/attention.py``,
``networks/decoders/fpn.py``, ``networks/encoders/mobilenetv2.py``).

Every object of a video is segmented in one pass: a mask (background
and up to ``MODEL_MAX_OBJ_NUM - 1`` objects, one-hot at the input size)
becomes an identity embedding (``patch_wise_id_bank``, a 17×17 conv of
stride 16) added to the memory's values.  A frame's tokens (the
encoder's stride-16 features projected to d, the grid row-major) pass
``LSTT_NUM`` long/short-term transformer blocks, each:

* self-attention over the frame's tokens, sine positions on its queries
  and keys (``norm1``);
* ``u = norm2(t)``, ``Q = K = linear_Q(u)``: the long-term attention over
  the memory (frame 0 and every ``MEM_EVERY``-th frame) plus the
  short-term attention over the previous frame in a window
  (``ops.attention``), each with its own projection;
* a feed-forward of ``linear1``, GroupNorm-GELU-depthwise 5×5 conv and
  ``linear2`` (``norm3``);

and an FPN decoder reads the projected features and every block's
output through the ``decoder_norms`` (the intermediate ones and the
final one) with the encoder's stride-4, -8 and -16 taps.  Once a frame's
mask is known, each block writes its memory: ``K = Q`` and
``V = linear_V(u + id)``, ``u`` and ``Q`` from the frame's own pass.  A
reference frame (a given mask and no memory) runs with its own written
keys and values as both memories (``lstt(..., id_emb=...)``).

Parameter names are the released state dict's (``encoder.*``,
``encoder_projector``, ``patch_wise_id_bank``, ``LSTT.layers.<i>.*``,
``LSTT.decoder_norms.*``, ``decoder.*``), except inside the encoder,
which is ``models/mobilenet.py``'s tower (``stem``, ``block_<i>``,
``head``) where the release has torchvision's ``features.<i>``.
Tokens are [n, d] tensors of one frame (the release's [n, batch, d]
with the batch of one).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..configs import Config
from ..ops.attention import full_attention, local_attention, memory_attention
from .mobilenet import MobileNetV2

# AOT-L (configs/models/aotl.py over default.py; the FFN width and the
# window are the release's constructor defaults)
D_MODEL = 256           # MODEL_ENCODER_EMBEDDING_DIM
HEADS = 8               # MODEL_SELF_HEADS, MODEL_ATT_HEADS
LSTT_NUM = 3            # MODEL_LSTT_NUM
FFN_DIM = 1024          # dim_feedforward
MAX_DIS = 7             # the short-term window, (2·7 + 1)²
ENCODER_DIMS = (24, 32, 96, 1280)   # MODEL_ENCODER_DIM: taps 4x, 8x, 16x, 16x
CONV_GN_GROUPS = 8      # ConvGN (networks/layers/basic.py)
FFN_GN_GROUPS = 32      # GNActDWConv2d
LN_EPS = 1e-5

# (long-term keys, long-term values, the int32 device tensor [0, valid
# rows]) and (short-term keys, short-term values), each [L, rows, d]
LongTerm = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
ShortTerm = Tuple[torch.Tensor, torch.Tensor]


def sine_positions(h: int, w: int, d: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding (``PositionEmbeddingSine(d / 2,
    normalize=True)``: temperature 10⁴, scale 2π, eps 1e-6) → float32
    [h·w, d], the y features first."""
    f = d // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    i = torch.arange(f, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(i, 2, rounding_mode="floor") / f)

    def embed(p):
        p = p[:, None] / dim_t
        return torch.stack((p[:, 0::2].sin(), p[:, 1::2].cos()),
                           dim=2).flatten(1)

    py = embed(y)[:, None, :].expand(h, w, f)
    px = embed(x)[None, :, :].expand(h, w, f)
    return torch.cat((py, px), dim=2).reshape(h * w, d)


class MultiheadAttention(nn.Module):
    """The release's ``MultiheadAttention`` (self-attention): Q, K and V
    projections, the product, then ``projection``."""

    def __init__(self):
        super().__init__()
        self.linear_Q = nn.Linear(D_MODEL, D_MODEL)
        self.linear_K = nn.Linear(D_MODEL, D_MODEL)
        self.linear_V = nn.Linear(D_MODEL, D_MODEL)
        self.projection = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, q, k, v):
        q, k, v = self.linear_Q(q), self.linear_K(k), self.linear_V(v)
        return self.projection(full_attention(q, k, v, HEADS))


class LongTermAttention(nn.Module):
    """``MultiheadAttention(use_linear=False)``: the product over the
    memory's valid rows, then ``projection``."""

    def __init__(self):
        super().__init__()
        self.projection = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, q, k, v, cu_k: Optional[torch.Tensor] = None):
        """k, v are the memory (``cu_k`` its valid rows) or, without
        ``cu_k``, exactly the keys to attend."""
        if cu_k is None:
            out = full_attention(q, k, v, HEADS)
        else:
            out = memory_attention(q, k, v, cu_k, HEADS)
        return self.projection(out)


class LocalAttention(nn.Module):
    """``MultiheadLocalAttention(use_linear=False)``: a
    (2·MAX_DIS + 1)² window of the previous frame, relative biases on the
    logits (``relative_emb_k``: a grouped 1×1 conv of the scaled query to
    heads × window) and on the values (``relative_emb_v``)."""

    def __init__(self):
        super().__init__()
        win = (2 * MAX_DIS + 1) ** 2
        self.relative_emb_k = nn.Conv2d(D_MODEL, HEADS * win, 1,
                                        groups=HEADS)
        self.relative_emb_v = nn.Parameter(torch.zeros(
            HEADS, D_MODEL // HEADS, win))
        self.projection = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, q, k, v, grid: Tuple[int, int]):
        n, d = q.shape
        qs = q * (d // HEADS) ** -0.5
        rel_k = self.relative_emb_k(qs.t().reshape(1, d, *grid))
        out = local_attention(q, k, v, rel_k.view(HEADS, -1, n),
                              self.relative_emb_v, HEADS, grid, MAX_DIS)
        return self.projection(out)


class GNActDWConv2d(nn.Module):
    """GroupNorm, GELU, then a depthwise 5×5 conv (no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gn = nn.GroupNorm(FFN_GN_GROUPS, dim)
        self.conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)

    def forward(self, x, grid: Tuple[int, int]):
        n, c = x.shape
        y = x.t().reshape(1, c, *grid)
        y = self.conv(F.gelu(self.gn(y)))
        return y.reshape(c, n).t()


class LSTTBlock(nn.Module):
    """``LongShortTermTransformerBlock`` (eval: no dropout, no drop
    path)."""

    def __init__(self):
        super().__init__()
        d = D_MODEL
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear_Q = nn.Linear(d, d)
        self.linear_V = nn.Linear(d, d)
        self.long_term_attn = LongTermAttention()
        self.short_term_attn = LocalAttention()
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = MultiheadAttention()
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, FFN_DIM)
        self.activation = GNActDWConv2d(FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, d)

    def forward(self, t, pos, grid, lt=None, st=None, id_emb=None):
        """One block → (t, Q, u).  With ``id_emb`` the block attends its
        own written keys and values (a reference frame); else ``lt`` =
        (keys, values, cu_k) and ``st`` = (keys, values) of this
        block."""
        x = self.norm1(t)
        qk = x + pos
        t = t + self.self_attn(qk, qk, x)
        u = self.norm2(t)
        q = self.linear_Q(u)
        if id_emb is not None:
            v = self.linear_V(u + id_emb)
            long = self.long_term_attn(q, q, v)
            short = self.short_term_attn(q, q, v, grid)
        else:
            long = self.long_term_attn(q, lt[0], lt[1], lt[2])
            short = self.short_term_attn(q, st[0], st[1], grid)
        t = t + long + short
        t = t + self.linear2(self.activation(self.linear1(self.norm3(t)),
                                             grid))
        return t, q, u


class LongShortTermTransformer(nn.Module):
    """The blocks and their ``decoder_norms``: the intermediate outputs
    normed by the first ``LSTT_NUM - 1`` norms, the last by the final one; each
    block takes the one before's output unnormed."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(LSTTBlock() for _ in range(LSTT_NUM))
        self.decoder_norms = nn.ModuleList(
            nn.LayerNorm(D_MODEL, eps=LN_EPS) for _ in range(LSTT_NUM))

    def forward(self, t, pos, grid, lt: Optional[LongTerm] = None,
                st: Optional[ShortTerm] = None, id_emb=None):
        """→ (the normed outputs [n, d] of every block, Q [L, n, d],
        u [L, n, d])."""
        outs, qs, us = [], [], []
        for i, layer in enumerate(self.layers):
            t, q, u = layer(
                t, pos, grid,
                None if lt is None else (lt[0][i], lt[1][i], lt[2]),
                None if st is None else (st[0][i], st[1][i]), id_emb)
            outs.append(self.decoder_norms[i](t))
            qs.append(q)
            us.append(u)
        return outs, torch.stack(qs), torch.stack(us)


class ConvGN(nn.Module):
    def __init__(self, indim: int, outdim: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(indim, outdim, kernel, padding=kernel // 2)
        self.gn = nn.GroupNorm(CONV_GN_GROUPS, outdim)

    def forward(self, x):
        return self.gn(self.conv(x))


class FPNSegmentationHead(nn.Module):
    """The FPN decoder: the inputs concatenated, then up from stride 16
    to 4 through the encoder's taps (bilinear ×2, corners aligned)."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int,
                 shortcut_dims: Sequence[int]):
        super().__init__()
        self.conv_in = ConvGN(in_dim, hidden, 1)
        self.conv_16x = ConvGN(hidden, hidden, 3)
        self.conv_8x = ConvGN(hidden, hidden // 2, 3)
        self.conv_4x = ConvGN(hidden // 2, hidden // 2, 3)
        self.adapter_16x = nn.Conv2d(shortcut_dims[-2], hidden, 1)
        self.adapter_8x = nn.Conv2d(shortcut_dims[-3], hidden, 1)
        self.adapter_4x = nn.Conv2d(shortcut_dims[-4], hidden // 2, 1)
        self.conv_out = nn.Conv2d(hidden // 2, out_dim, 1)

    def forward(self, inputs: List[torch.Tensor], shortcuts):
        x = F.relu(self.conv_in(torch.cat(inputs, dim=1)))
        x = F.relu(self.conv_16x(self.adapter_16x(shortcuts[-2]) + x))
        x = F.interpolate(x, size=shortcuts[-3].shape[-2:], mode="bilinear",
                          align_corners=True)
        x = F.relu(self.conv_8x(self.adapter_8x(shortcuts[-3]) + x))
        x = F.interpolate(x, size=shortcuts[-4].shape[-2:], mode="bilinear",
                          align_corners=True)
        x = F.relu(self.conv_4x(self.adapter_4x(shortcuts[-4]) + x))
        return self.conv_out(x)


class AOT(nn.Module):
    kind = "aot"

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.MODEL_BACKBONE != "mobilenet":
            raise ValueError(f"AOT runs on MobileNetV2, not "
                             f"{cfg.MODEL_BACKBONE!r}")
        self.cfg = cfg
        d, dims = D_MODEL, ENCODER_DIMS
        self.encoder = MobileNetV2(cfg.MODEL_OUTPUT_STRIDE,
                                   last_channel=dims[-1])
        self.encoder_projector = nn.Conv2d(dims[-1], d, 1)
        self.LSTT = LongShortTermTransformer()
        self.decoder = FPNSegmentationHead(d * (LSTT_NUM + 1),
                                           cfg.MODEL_MAX_OBJ_NUM, d, dims)
        self.patch_wise_id_bank = nn.Conv2d(cfg.MODEL_MAX_OBJ_NUM, d, 17,
                                            stride=16, padding=8)
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Normalised frames [K, 3, H, W] → the taps [K, C, h, w] at
        strides 4, 8, 16 and the projected stride-16 features [K, d, h,
        w]."""
        taps = self.encoder.taps(x)
        taps[-1] = self.encoder_projector(taps[-1])
        return taps

    def positions(self, grid: Tuple[int, int], like: torch.Tensor
                  ) -> torch.Tensor:
        """The sine positions [n, d] of ``grid`` in ``like``'s dtype, made
        once per grid, device and dtype."""
        key = (grid, like.device, like.dtype)
        p = self._pos.get(key)
        if p is None:
            p = self._pos[key] = sine_positions(
                grid[0], grid[1], D_MODEL, like.device).to(like.dtype)
        return p

    def id_embed(self, onehot: torch.Tensor) -> torch.Tensor:
        """One-hot masks [B, O, H, W] at the input size → identity tokens
        [B, n, d]."""
        e = self.patch_wise_id_bank(onehot)
        return e.flatten(2).transpose(1, 2)

    def lstt(self, feat: torch.Tensor, lt: Optional[LongTerm] = None,
             st: Optional[ShortTerm] = None,
             id_emb: Optional[torch.Tensor] = None):
        """One frame's projected features [d, h, w] through the blocks →
        (normed outputs, Q [L, n, d], u [L, n, d]); a reference frame
        with ``id_emb`` [n, d] and no memory."""
        d, h, w = feat.shape
        t = feat.reshape(d, h * w).t()
        return self.LSTT(t, self.positions((h, w), t), (h, w), lt, st,
                         id_emb)

    def decode(self, taps: Sequence[torch.Tensor], outs: List[torch.Tensor]
               ) -> torch.Tensor:
        """One frame's taps ([1, C, h, w] each) and block outputs → the
        logits [O, H/4, W/4]."""
        d, h, w = taps[-1].shape[1:]
        inputs = [taps[-1]] + [o.t().reshape(1, d, h, w) for o in outs]
        return self.decoder(inputs, taps)[0]

    def memory_kv(self, qs: torch.Tensor, us: torch.Tensor,
                  id_emb: torch.Tensor):
        """The keys and values a frame writes, [L, n, d] each: K = Q and
        V = linear_V(u + id), per block."""
        vs = [layer.linear_V(us[i] + id_emb)
              for i, layer in enumerate(self.LSTT.layers)]
        return qs, torch.stack(vs)
