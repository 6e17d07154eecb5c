"""Plain float32 AOT-L and the output check of an AOT cell.

Written from the semantics of aot-benchmark (``networks/models/aot.py``,
``networks/layers/transformer.py``, ``networks/layers/attention.py``,
``networks/decoders/fpn.py``, ``networks/encoders/mobilenetv2.py``,
``networks/engines/aot_engine.py``) as plain functional PyTorch over a
state dict under the port's key names, frame by frame: no kernel, cache,
graph or batching of the program.  Nothing here imports the program or
JAX; ``check_video`` turns TF32 off (``aocnet.plain_precision``).
Every convolution, linear layer and attention product takes its
operands through ``Ref.cast`` (the identity, or ``aocnet.fp8_cast`` for
the control).

The network, at AOT-L's widths (d = 256, 8 heads of dh = 32, 3 blocks,
a feed-forward of 1024, a 15×15 window): MobileNetV2 at output stride 16
with its taps (24 channels at stride 4, 32 at 8, 96 at 16, and a 1×1 ConvBN-relu6 from
320 to 1280 at 16), a 1×1 projector to d; identities from a 17×17
stride-16 conv of the one-hot mask at the input size; DETR's normalised
sine positions on self-attention's queries and keys; per block
``t += SelfAttn(LN1 t + pos, LN1 t + pos, LN1 t)``, ``u = LN2 t``,
``Q = K = W_Q u``, ``t += P_lt softmax(Q K_ltᵀ/√dh) V_lt + P_st local``,
``t += W2 DWConv5×5(GELU(GN32(W1 LN3 t)))``; the local attention over a
(2·max_dis + 1)² window of the previous frame, the window unfolded with
zero padding and its positions outside the frame masked out of the
softmax, with ``relative_emb_k`` of the scaled query on the logits and
``relative_emb_v`` on the values; the decoder norms on every block's
output; the FPN decoder (ConvGN with 8 groups).  A frame writes
``K = Q`` and ``V = W_V(u + id)`` per block.

Departures from the release, shared with the program: the encoder's
dilation rule is the port's MobileNetV2 tower's (once at stride 16 every
later stride becomes dilation, the first 160-channel block included); a
frame that brings a given mask (a join) writes its merged mask from its
own pass and joins the long-term memory, where the release runs a second
reference pass and restarts the memory gap there; the memory gap counts
from frame 0 (frames 0, 5, 10, ...); the probabilities are a softmax over
the labels given so far.

The check (``check_video``): whole videos part between two correct
implementations from rounding alone, so the reference follows the
program's masks, as ``video.py`` does for the AOC cells: its memory is
written from the program's masks (frame 0's and each join's given mask
spliced in), everything else (the features, the passes, the keys and
values, the probabilities) it works out itself at each frame; each pixel
of the program's mask is scored by the gap between the reference's best
probability there and its probability of the program's label.  Pixels
that a join frame's given mask sets are not scored.  The control runs a
second reference with ``control_cast`` along the same masks and scores
the label it puts first.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .aocnet import MBV2_STAGES, Ref, nearest, plain_precision
from .video import Scores, eval_size, normalise, resize_frames

LN_EPS = 1e-5
D, HEADS, BLOCKS, MAX_DIS = 256, 8, 3, 7


class AOTRef(Ref):
    """AOT-L's functions over ``sd``, with ``cfg``'s (the configuration's
    fields) object channels."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict,
                 cast: Optional[Callable] = None):
        super().__init__(sd, "mobilenet", cast)
        self.d, self.heads, self.n_layers = D, HEADS, BLOCKS
        self.max_dis = MAX_DIS
        self.o = cfg["MODEL_MAX_OBJ_NUM"]

    # -- encoder -----------------------------------------------------------
    def encode(self, x):
        """[N, 3, H, W] → [x4, x8, x16, projected x16]."""
        p = "encoder"
        x = self._conv_bn6(p + ".stem", x, stride=2)
        stride, dilation, in_ch, idx, taps = 2, 1, 32, 0, []
        for t, c, n, s in MBV2_STAGES:
            for i in range(n):
                st = s if i == 0 else 1
                if stride >= 16 and st > 1:
                    dilation *= st
                    st = 1
                else:
                    stride *= st
                b = f"{p}.block_{idx}"
                hidden = in_ch * t
                y = x if t == 1 else self._conv_bn6(b + ".expand", x)
                y = self._conv_bn6(b + ".depthwise", y, st, dilation, hidden)
                y = self.fbn(b + ".project_bn", self.conv(b + ".project", y))
                x = x + y if (st == 1 and in_ch == c) else y
                in_ch = c
                idx += 1
            if c in (24, 32, 96):
                taps.append(x)
        x = self._conv_bn6(p + ".head", x)
        return taps + [self.conv("encoder_projector", x)]

    # -- pieces ------------------------------------------------------------
    def positions(self, h, w):
        f = self.d // 2
        dev = self.sd["encoder_projector.weight"].device
        dim_t = 10000.0 ** (2 * (torch.arange(f, device=dev) // 2).float()
                            / f)

        def axis(size):
            p = (torch.arange(size, device=dev).float() + 1) / (size + 1e-6)
            p = p[:, None] * (2 * math.pi) / dim_t
            out = torch.empty_like(p)
            out[:, 0::2] = p[:, 0::2].sin()
            out[:, 1::2] = p[:, 1::2].cos()
            return out

        py = axis(h)[:, None, :].expand(h, w, f)
        px = axis(w)[None, :, :].expand(h, w, f)
        return torch.cat([py, px], dim=2).reshape(h * w, self.d)

    def ln(self, p, x):
        return F.layer_norm(x, (x.shape[-1],), self.sd[p + ".weight"],
                            self.sd[p + ".bias"], LN_EPS)

    def attend(self, q, k, v, heads):
        """softmax(q kᵀ/√dh) v, head by head: [n, d], [m, d], [m, d]."""
        n, d = q.shape
        dh = d // heads
        out = []
        for h in range(heads):
            sl = slice(h * dh, (h + 1) * dh)
            a = torch.softmax(self.mm(q[:, sl], k[:, sl].t()) / math.sqrt(dh),
                              dim=-1)
            out.append(self.mm(a, v[:, sl]))
        return torch.cat(out, dim=1)

    def local(self, p, q, k, v, grid):
        """The short-term attention before its projection."""
        c = self.cast
        (h, w), heads, r = grid, self.heads, self.max_dis
        n, d = q.shape
        dh, win = d // heads, 2 * r + 1
        qs = q / math.sqrt(dh)
        rel_k = self.conv(p + ".relative_emb_k", qs.t().reshape(1, d, h, w),
                          groups=heads).reshape(heads, win * win, n)

        def unfold(x):
            return F.unfold(x.t().reshape(1, -1, h, w), win, padding=r)

        kk = unfold(k).reshape(heads, dh, win * win, n)
        vv = unfold(v).reshape(heads, dh, win * win, n)
        inside = unfold(torch.ones((n, 1), device=q.device))[0] > 0
        logits = torch.einsum("hcn,hcwn->hwn",
                              c(qs.t().reshape(heads, dh, n)), c(kk)) + rel_k
        attn = torch.softmax(logits.masked_fill(~inside, float("-inf")),
                             dim=1)
        out = (torch.einsum("hwn,hcwn->hcn", c(attn), c(vv))
               + torch.einsum("hwn,hcw->hcn", c(attn),
                              c(self.sd[p + ".relative_emb_v"])))
        return out.reshape(d, n).t()

    def ffn(self, p, x, grid):
        y = self.linear(p + ".linear1", self.ln(p + ".norm3", x))
        f = y.shape[1]
        y = F.gelu(self.gn(p + ".activation.gn", y.t().reshape(1, f, *grid),
                           32))
        y = self.conv(p + ".activation.conv", y, padding=2, groups=f)
        return self.linear(p + ".linear2", y.reshape(f, -1).t())

    def block(self, i, t, pos, grid, lt=None, st=None, id_emb=None):
        """Block i → (t, Q, u); a reference pass with ``id_emb``, else
        over ``lt`` and ``st`` = (keys, values)."""
        p = f"LSTT.layers.{i}"
        x = self.ln(p + ".norm1", t)
        qk = x + pos
        sa = p + ".self_attn"
        att = self.attend(self.linear(sa + ".linear_Q", qk),
                          self.linear(sa + ".linear_K", qk),
                          self.linear(sa + ".linear_V", x), self.heads)
        t = t + self.linear(sa + ".projection", att)
        u = self.ln(p + ".norm2", t)
        q = self.linear(p + ".linear_Q", u)
        if id_emb is not None:
            v = self.linear(p + ".linear_V", u + id_emb)
            lt = st = (q, v)
        long = self.attend(q, lt[0], lt[1], self.heads)
        short = self.local(p + ".short_term_attn", q, st[0], st[1], grid)
        t = (t + self.linear(p + ".long_term_attn.projection", long)
             + self.linear(p + ".short_term_attn.projection", short))
        return t + self.ffn(p, t, grid), q, u

    def conv_gn(self, p, x):
        k = self.sd[p + ".conv.weight"].shape[-1]
        return self.gn(p + ".gn", self.conv(p + ".conv", x, padding=k // 2),
                       8)

    def decode(self, taps, outs, grid):
        p = "decoder"
        d = self.d
        x = torch.cat([taps[3]] + [o.t().reshape(1, d, *grid) for o in outs],
                      dim=1)
        x = F.relu(self.conv_gn(p + ".conv_in", x))
        x = F.relu(self.conv_gn(p + ".conv_16x", self.conv(
            p + ".adapter_16x", taps[2]) + x))
        x = F.interpolate(x, size=taps[1].shape[-2:], mode="bilinear",
                          align_corners=True)
        x = F.relu(self.conv_gn(p + ".conv_8x", self.conv(
            p + ".adapter_8x", taps[1]) + x))
        x = F.interpolate(x, size=taps[0].shape[-2:], mode="bilinear",
                          align_corners=True)
        x = F.relu(self.conv_gn(p + ".conv_4x", self.conv(
            p + ".adapter_4x", taps[0]) + x))
        return self.conv(p + ".conv_out", x)[0]

    def id_embed(self, lab):
        """A label map at the input size → identity tokens [n, d]."""
        onehot = (lab[None] == torch.arange(
            self.o, device=lab.device)[:, None, None]).float()
        e = self.conv("patch_wise_id_bank", onehot[None], stride=16,
                      padding=8)
        return e[0].reshape(self.d, -1).t()

    # -- a frame -----------------------------------------------------------
    def passes(self, taps, lt=None, st=None, id_emb=None):
        """The blocks over one frame's taps ([1, C, h, w] each) → (normed
        outputs, Qs, us); ``lt``/``st`` per block (keys, values)."""
        grid = tuple(taps[3].shape[-2:])
        t = taps[3][0].reshape(self.d, -1).t()
        pos = self.positions(*grid)
        outs, qs, us = [], [], []
        for i in range(self.n_layers):
            t, q, u = self.block(i, t, pos, grid,
                                 None if lt is None else lt[i],
                                 None if st is None else st[i], id_emb)
            outs.append(self.ln(f"LSTT.decoder_norms.{i}", t))
            qs.append(q)
            us.append(u)
        return outs, qs, us

    def write(self, qs, us, id_emb):
        """Per block the (keys, values) a frame writes."""
        return [(q, self.linear(f"LSTT.layers.{i}.linear_V", u + id_emb))
                for i, (q, u) in enumerate(zip(qs, us))]

    def reference(self, taps, lab):
        """A reference frame (``lab`` at the input size) → its writes."""
        id_emb = self.id_embed(lab)
        _, qs, us = self.passes(taps, id_emb=id_emb)
        return self.write(qs, us, id_emb)

    def step(self, taps, lt: List, st: List):
        """A frame over the memory (``lt``: per written frame its
        per-block writes; ``st``: the previous frame's) → (logits [O,
        H/4, W/4], (Qs, us))."""
        mem = [(torch.cat([f[i][0] for f in lt]),
                torch.cat([f[i][1] for f in lt]))
               for i in range(self.n_layers)]
        outs, qs, us = self.passes(taps, mem, st)
        return self.decode(taps, outs, tuple(taps[3].shape[-2:])), (qs, us)


@torch.no_grad()
def centre_logits(sd: Dict[str, torch.Tensor], cfg: Dict, frames: np.ndarray,
                  label0: np.ndarray, device) -> None:
    """Set ``decoder.conv_out.bias`` in ``sd`` so that each channel's
    logits average 0 over frame 1 of ``frames`` (uint8 [T, H0, W0, 3]),
    run after frame 0's reference pass on ``label0``, by the float32
    reference."""
    with plain_precision():
        ref = AOTRef(sd, cfg)
        hw = eval_size(*frames.shape[1:3], cfg["TEST_MAX_SIZE"])
        x = normalise(resize_frames(torch.from_numpy(frames[:2]).to(device),
                                    hw))
        lab = torch.from_numpy(label0.astype(np.int64)).to(device)
        st = ref.reference(ref.encode(x[0:1]), nearest(lab, hw))
        logits, _ = ref.step(ref.encode(x[1:2]), [st], st)
        sd["decoder.conv_out.bias"] = (sd["decoder.conv_out.bias"]
                                       - logits.mean(dim=(1, 2)))


def probabilities(logits, hw, em):
    """Logits [O, h, w] → the softmax over the labels with ``em`` set, at
    ``hw`` (bilinear, corners aligned)."""
    x = F.interpolate(logits[None], size=hw, mode="bilinear",
                      align_corners=True)[0]
    x = x.masked_fill(em[:, None, None] == 0, float("-inf"))
    return torch.softmax(x, dim=0)


@torch.no_grad()
def check_video(sd: Dict[str, torch.Tensor], cfg: Dict, frames: np.ndarray,
                labels: Dict[int, np.ndarray], masks: Dict[int, np.ndarray],
                device, scores: Scores,
                control_cast: Optional[Callable] = None,
                control: Optional[Scores] = None) -> None:
    """Score the program's ``masks`` {frame: uint8 [H0, W0]} of one video
    (``frames`` uint8 [T, H0, W0, 3], ``labels`` the given masks) into
    ``scores`` (and the control's choices into ``control``)."""
    with plain_precision():
        _check_video(sd, cfg, frames, labels, masks, device, scores,
                     control_cast, control)


def _check_video(sd, cfg, frames, labels, masks, device, scores,
                 control_cast, control):
    o, gap = cfg["MODEL_MAX_OBJ_NUM"], cfg["MEM_EVERY"]
    t_len, h0, w0, _ = frames.shape
    hw = eval_size(h0, w0, cfg["TEST_MAX_SIZE"])
    refs = [AOTRef(sd, cfg)]
    if control_cast is not None:
        refs.append(AOTRef(sd, cfg, control_cast))
    lts: List[List] = [[] for _ in refs]
    sts: List = [None for _ in refs]
    em = torch.zeros(o, device=device)
    chunk = 8
    for lo in range(0, t_len, chunk):
        x = normalise(resize_frames(
            torch.from_numpy(frames[lo:lo + chunk]).to(device), hw))
        for j in range(x.shape[0]):
            t = lo + j
            join = None
            if t in labels:
                join = torch.from_numpy(labels[t].astype(np.int64)).to(device)
                for lid in torch.unique(join).tolist():
                    if lid != 255 and lid < o:
                        em[lid] = 1.0
            taps = [ref.encode(x[j:j + 1]) for ref in refs]
            if t == 0:
                lab = nearest(join, hw)
                for r, ref in enumerate(refs):
                    sts[r] = ref.reference(taps[r], lab)
                    lts[r] = [sts[r]]
                continue
            probs, pend = [], []
            for r, ref in enumerate(refs):
                logits, qu = ref.step(taps[r], lts[r], sts[r])
                probs.append(probabilities(logits, (h0, w0), em))
                pend.append(qu)
            pm = probs[0]
            prog = torch.from_numpy(masks[t].astype(np.int64)).to(device)
            keep = torch.ones_like(prog, dtype=torch.bool) if join is None \
                else join == 0
            best = pm.max(dim=0).values
            score = best - pm.gather(0, prog[None])[0]
            scores.add(score[keep], (prog != pm.argmax(dim=0))[keep])
            if control is not None:
                pick = probs[1].argmax(dim=0)
                cgap = best - pm.gather(0, pick[None])[0]
                control.add(cgap[keep], (pick != pm.argmax(dim=0))[keep])
            lab = nearest(prog, hw)
            for r, ref in enumerate(refs):
                sts[r] = ref.write(*pend[r], ref.id_embed(lab))
                if join is not None or (gap > 0 and t % gap == 0):
                    lts[r].append(sts[r])
