"""Plain float32 AOC-Net: the benchmark's reference for one frame.

Written from the reference implementation's semantics (AOC-Net,
``networks/aoc``, ``networks/deeplab``, ``networks/layers``) as plain
functional PyTorch over a state dict under the reference's key names.
It starts from a frozen copy of the repository's test oracle
(``tests/torch_oracle.py``) and adds what the streaming evaluator runs:
the MobileNetV2 backbone (``networks/deeplab/backbone/mobilenet.py``,
width 1.0, output stride 16), the multi-slot bank's masked pools, the
object-validity masks of the decoder and of the fg→bg maps, and the
decoder's two-slot feature memory.

Every convolution, linear layer and distance product takes its operands
through ``Ref.cast``: the identity for the reference, and a rounding to a
lower precision for the control (``fp8_cast``).  Nothing here imports the
program or JAX; callers turn TF32 off (``plain_precision``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

WRONG = 5.0e4
EPS = 1e-5

# MobileNetV2 stages: (expand ratio, output channels, blocks, first stride)
MBV2_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


@contextlib.contextmanager
def plain_precision():
    """float32 products in float32: both TF32 switches off (and cuDNN left
    to time its algorithms for each new shape: its untimed choice for the
    decoder's dilated float32 convolutions is slow)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (the tensor's
    absolute max onto e4m3's 448), back in float32: the operands of an
    fp8 product with float32 accumulation."""
    amax = x.detach().abs().max().clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def nearest_index(out_size: int, in_size: int, device) -> torch.Tensor:
    """The legacy nearest rule, ``src = floor(dst * in / out)``, with the
    ratio in float64."""
    src = np.minimum((np.arange(out_size) * (in_size / out_size))
                     .astype(np.int64), in_size - 1)
    return torch.from_numpy(src).to(device)


def nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of the last two axes."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    iy = nearest_index(hw[0], h, x.device)
    ix = nearest_index(hw[1], w, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


class Ref:
    """The network's functions over ``sd`` (name → float32 tensor).
    ``cast``: applied to both operands of every product (identity for
    the reference)."""

    def __init__(self, sd: Dict[str, torch.Tensor], backbone: str = "resnet",
                 cast: Optional[Callable] = None):
        self.sd = sd
        self.backbone = backbone
        self.cast = cast or (lambda t: t)

    # -- primitives ------------------------------------------------------
    def conv(self, p, x, stride=1, padding=0, dilation=1, groups=1):
        sd, c = self.sd, self.cast
        b = sd.get(p + ".bias")
        return F.conv2d(c(x), c(sd[p + ".weight"]), b, stride=stride,
                        padding=padding, dilation=dilation, groups=groups)

    def fbn(self, p, x):
        sd = self.sd
        scale = sd[p + ".weight"] * torch.rsqrt(sd[p + ".running_var"] + EPS)
        shift = sd[p + ".bias"] - sd[p + ".running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def gn(self, p, x, groups):
        return F.group_norm(x, groups, self.sd[p + ".weight"],
                            self.sd[p + ".bias"], eps=EPS)

    def linear(self, p, h):
        c = self.cast
        return F.linear(c(h), c(self.sd[p + ".weight"]), self.sd[p + ".bias"])

    def mm(self, a, b):
        return self.cast(a) @ self.cast(b)

    # -- feature extraction ------------------------------------------------
    def _res_bottleneck(self, p, x, stride, dilation, has_ds):
        out = F.relu(self.fbn(p + ".bn1", self.conv(p + ".conv1", x)))
        out = F.relu(self.fbn(p + ".bn2", self.conv(
            p + ".conv2", out, stride=stride, padding=dilation,
            dilation=dilation)))
        out = self.fbn(p + ".bn3", self.conv(p + ".conv3", out))
        res = x
        if has_ds:
            res = self.fbn(p + ".downsample.1",
                           self.conv(p + ".downsample.0", x, stride=stride))
        return F.relu(out + res)

    def resnet101(self, x):
        p = "feature_extracter.backbone"
        x = self.conv(p + ".conv1", x, stride=2, padding=3)
        x = F.relu(self.fbn(p + ".bn1", x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)

        def layer(x, name, planes, n, stride, dilation, grid=None):
            inpl = x.shape[1]
            for i in range(n):
                d = dilation * (grid[i] if grid else 1)
                s = stride if i == 0 else 1
                ds = (i == 0) and (stride != 1 or inpl != planes * 4)
                x = self._res_bottleneck(f"{p}.{name}.{i}", x, s, d, ds)
                inpl = planes * 4
            return x

        x = layer(x, "layer1", 64, 3, 1, 1)
        low = x
        x = layer(x, "layer2", 128, 4, 2, 1)
        x = layer(x, "layer3", 256, 23, 2, 1)
        x = layer(x, "layer4", 512, 3, 1, 2, grid=(1, 2, 4))
        return x, low

    def _conv_bn6(self, p, x, stride=1, dilation=1, groups=1):
        k = self.sd[p + ".conv.weight"].shape[-1]
        pad = (k - 1) // 2 * dilation
        y = self.conv(p + ".conv", x, stride=stride, padding=pad,
                      dilation=dilation, groups=groups)
        return F.relu6(self.fbn(p + ".bn", y))

    def mobilenetv2(self, x):
        """Inverted residuals at output stride 16: once the stride reaches
        16 a block's stride becomes dilation; the low-level features are
        the last 24-channel block's."""
        p = "feature_extracter.backbone"
        x = self._conv_bn6(p + ".stem", x, stride=2)
        stride, dilation, in_ch, idx, low = 2, 1, 32, 0, None
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
            if c == 24:
                low = x
        return x, low

    def deeplab_aspp(self, x):
        p = "feature_extracter.aspp"
        outs = []
        for name, (k, d) in zip(("aspp1", "aspp2", "aspp3", "aspp4"),
                                ((1, 1), (3, 6), (3, 12), (3, 18))):
            y = self.conv(f"{p}.{name}_conv", x, padding=0 if k == 1 else d,
                          dilation=d)
            outs.append(F.relu(self.fbn(f"{p}.{name}_bn", y)))
        x5 = x.mean(dim=(2, 3), keepdim=True)
        x5 = F.relu(self.fbn(p + ".gap_bn", self.conv(p + ".gap_conv", x5)))
        x5 = x5.expand(-1, -1, outs[0].shape[2], outs[0].shape[3])
        x = torch.cat(outs + [x5], dim=1)
        return F.relu(self.fbn(p + ".bn1", self.conv(p + ".conv1", x)))

    def deeplab_decoder(self, x, low):
        p = "feature_extracter.decoder"
        ll = F.relu(self.fbn(p + ".bn1", self.conv(p + ".conv1", low)))
        x = F.interpolate(x, size=ll.shape[2:], mode="bilinear",
                          align_corners=True)
        x = torch.cat([x, ll], dim=1)
        x = F.relu(self.fbn(p + ".last_bn0",
                            self.conv(p + ".last_conv0", x, padding=1)))
        return F.relu(self.fbn(p + ".last_bn1",
                               self.conv(p + ".last_conv1", x, padding=1)))

    def extract_feature(self, x_nchw):
        """[N, 3, H, W] normalised → (embedding [N, C, h, w], low-level
        [N, 256 or 24, h, w])."""
        net = self.mobilenetv2 if self.backbone == "mobilenet" else \
            self.resnet101
        feats, low = net(x_nchw)
        x = self.deeplab_decoder(self.deeplab_aspp(feats), low)
        p = "semantic_embedding"
        x = self.conv(p + ".seperate_conv", x, padding=1, groups=x.shape[1])
        x = F.relu(self.gn(p + ".bn1", x, 32))
        x = self.conv(p + ".embedding_conv", x)
        return F.relu(self.gn(p + ".bn2", x, 25)), low

    # -- matching ----------------------------------------------------------
    def sq_dist(self, q, r):
        """[M, C] × [R, C] → squared distances [M, R]."""
        return (q.pow(2).sum(1)[:, None] + r.pow(2).sum(1)[None]
                - 2.0 * self.mm(q, r.t()))

    def global_matching(self, q, r_emb, r_lab, bias, block: int = 4096):
        """Per object, the nearest bank row of its label → squashed
        [M, O]; rows of another label cost WRONG more."""
        wrong = (r_lab < 0.1).float() * WRONG                      # [R, O]
        out = []
        for i in range(0, q.shape[0], block):
            d = self.sq_dist(q[i:i + block], r_emb)
            out.append(torch.stack([(d + wrong[None, :, k]).min(dim=1).values
                                    for k in range(r_lab.shape[1])], dim=1))
        return squash(torch.cat(out), bias)

    def kmeans(self, pts, weights, scores, k, iters):
        """Lloyd's algorithm for one object: the k rows with the highest
        ``scores·weights`` seed the centroids (a stable descending order,
        the lower row first among equals); then ``iters`` rounds; returns
        the centroids and the means of the final assignment, each with
        its validity."""
        s = scores * weights
        order = torch.sort(s, descending=True, stable=True)
        top_s, idx = order.values[:k], order.indices[:k]
        cent_valid = top_s > 0.0
        cent = pts[idx].clone()

        def update(c):
            d = self.sq_dist(pts, c)
            d = torch.where(cent_valid[None], d, torch.full_like(d, np.inf))
            onehot = F.one_hot(d.argmin(dim=1), k).float() * weights[:, None]
            counts = onehot.sum(0)
            new = torch.where(counts[:, None] > 0,
                              (onehot.t() @ pts) / counts.clamp(min=1.0)[:, None],
                              c)
            return new, counts

        for _ in range(iters):
            cent, _ = update(cent)
        means, counts = update(cent)
        return cent, cent_valid, means, (counts > 0) & cent_valid

    def cluster_matching(self, q, r_emb, r_lab, bias, scores, k, iters):
        """Per object k-means over its bank rows; two maps per object: the
        nearest centroid and the nearest cluster mean → [M, O, 2]."""
        d1s, d2s = [], []
        for i in range(r_lab.shape[1]):
            with torch.no_grad():       # no gradient through Lloyd
                cent, cv, means, mv = self.kmeans(
                    r_emb.detach(), r_lab[:, i].detach(), scores[i], k, iters)
            for bank, valid, acc in ((cent, cv, d1s), (means, mv, d2s)):
                d = self.sq_dist(q, bank) + (1.0 - valid.float())[None] * WRONG
                acc.append(d.min(dim=1).values)
        d = torch.stack([torch.stack(d1s, 1), torch.stack(d2s, 1)], dim=-1)
        return squash(d, bias)

    @staticmethod
    def pos_neg(emb, lab, valid_px, epsilon):
        """Masked pools over the valid pixels: each object's mean and the
        mean of the rest → [O, C] twice."""
        lab = lab * valid_px[:, None]
        pos_sum = lab.t() @ emb
        pos_num = lab.sum(0)[:, None]
        tot_sum = (emb * valid_px[:, None]).sum(0)[None]
        tot_num = valid_px.sum()
        return (pos_sum / (pos_num + epsilon),
                (tot_sum - pos_sum) / (tot_num - pos_num + epsilon))

    def proxy_matching(self, q, proxies, bias):
        return squash(self.sq_dist(q, proxies), bias)

    def local_matching(self, query_hwc, prev_hwc, labels_hwo, bias, radii,
                       allow_downsample=True, atrous_rate=1):
        """Windowed matching against the previous frame: downsample 2×
        (bilinear, labels nearest), the (2D+1)² window of each pixel,
        other labels' offsets at WRONG, the min per radius (full radius
        first), squash, upsample → [H, W, O, n_radii]."""
        ori_h, ori_w, c = query_hwc.shape
        o = labels_hwo.shape[-1]
        max_d = int(radii[-1])
        x = query_hwc.permute(2, 0, 1)[None]
        y = prev_hwc.permute(2, 0, 1)[None]
        if allow_downsample:
            dh, dw = ori_h // 2 + 1, ori_w // 2 + 1
            x = F.interpolate(x, size=(dh, dw), mode="bilinear",
                              align_corners=True)
            y = F.interpolate(y, size=(dh, dw), mode="bilinear",
                              align_corners=True)
        _, _, h, w = x.shape
        pad_d = max_d - max_d % atrous_rate
        a_max = pad_d // atrous_rate
        k = 2 * a_max + 1
        x2 = x.pow(2).sum(1).view(h, w, 1)
        y2 = y.pow(2).sum(1).view(1, 1, h, w)
        pad = (pad_d,) * 4
        py = F.pad(y, pad)
        py2 = F.pad(y2, pad, value=WRONG)
        off_y2 = F.unfold(py2, kernel_size=(h, w), stride=atrous_rate)
        off_y2 = off_y2.view(h, w, -1)
        off_y = F.unfold(py, kernel_size=(h, w), stride=atrous_rate)
        off_y = off_y.view(c, h * w, -1).permute(1, 0, 2)       # [hw, C, K²]
        xq = x.view(c, h * w, 1).permute(1, 2, 0)               # [hw, 1, C]
        cross = torch.matmul(self.cast(xq), self.cast(off_y))
        d = x2 + off_y2 - 2.0 * cross.view(h, w, -1)
        del off_y, cross
        lab = labels_hwo.permute(2, 0, 1).float()                # [O, h', w']
        if (h, w) != (ori_h, ori_w):
            lab = nearest(lab, (h, w))
        plab = F.pad(lab[:, None], pad, value=0.0)               # [O,1,..]
        masks = F.unfold(plab, kernel_size=(h, w), stride=atrous_rate)
        masks = masks.view(o, h, w, -1).permute(1, 2, 3, 0) > 0.9
        d_masked = torch.where(masks, d[..., None],
                               torch.full((), WRONG, device=d.device))
        multi = [d_masked.min(dim=2).values.permute(2, 0, 1)[:, None]]
        cube = d_masked.view(h, w, k, k, o)
        for r in radii[:-1]:
            r = int(r) // atrous_rate
            lo, hi = a_max - r, a_max + r + 1
            sub = cube[:, :, lo:hi, lo:hi, :].reshape(h, w, -1, o)
            multi.append(sub.min(dim=2).values.permute(2, 0, 1)[:, None])
        md = torch.cat(multi, dim=1)                             # [O, n, h, w]
        md = (torch.sigmoid(md + bias.view(-1, 1, 1, 1)) - 0.5) * 2.0
        if (h, w) != (ori_h, ori_w):
            md = F.interpolate(md, size=(ori_h, ori_w), mode="bilinear",
                               align_corners=True)
        return md.permute(2, 3, 0, 1)

    # -- decoder -----------------------------------------------------------
    def ia_gate(self, p, x, head):
        return x * (1.0 + torch.tanh(self.linear(p + ".IA", head)))[:, :, None,
                                                                    None]

    def gct(self, p, x):
        sd = self.sd
        emb = (x.pow(2).sum((2, 3), keepdim=True) + EPS).pow(0.5) \
            * sd[p + ".alpha"]
        norm = sd[p + ".gamma"] / (emb.pow(2).mean(dim=1, keepdim=True)
                                   + EPS).pow(0.5)
        return x * (1.0 + torch.tanh(emb * norm + sd[p + ".beta"]))

    def gn_bottleneck(self, p, x, stride=1, dilation=1):
        out = self.gct(p + ".GCT1", x)
        out = F.relu(self.gn(p + ".bn1", self.conv(p + ".conv1", out), 32))
        out = F.relu(self.gn(p + ".bn2", self.conv(
            p + ".conv2", out, stride=stride, padding=dilation,
            dilation=dilation), 32))
        out = self.gn(p + ".bn3", self.conv(p + ".conv3", out), 32)
        res = x
        if p + ".downsample.0.weight" in self.sd:
            res = self.gn(p + ".downsample_gn",
                          self.conv(p + ".downsample.0", x, stride=stride), 32)
        return F.relu(out + res)

    def cond_layer(self, p, z, beta_pct):
        if z.dim() == 2:
            return self.linear(p + ".mlp_layer", z)
        o, c, h, w = z.shape
        phi = self.conv(p + ".phi_layer", z).view(o, h * w)
        beta_rank = max(1, int(beta_pct * h * w))
        kth = torch.topk(phi, beta_rank, dim=-1).values[:, -1:]
        mask = (phi > kth).float()
        pooled = (z.view(o, c, h * w) * mask[:, None]).sum(-1) / float(h * w)
        return self.linear(p + ".mlp_layer", pooled)

    def cond_block(self, p, x, head, ov, beta_pct):
        delta = inter_object_delta(x, ov)
        cl1 = self.cond_layer(p + ".CL_1", x, beta_pct)
        cl2 = self.cond_layer(p + ".CL_2", delta, beta_pct)
        cl3 = self.cond_layer(p + ".CL_3", head, 1.0)
        a = self.linear(p + ".mlp_layer", torch.cat([cl1, cl2, cl3], dim=1))
        return x * (1.0 + torch.tanh(a))[:, :, None, None]

    def gn_aspp(self, p, x):
        outs = []
        for name, (k, d) in zip(("aspp1", "aspp2", "aspp3", "aspp4"),
                                ((1, 1), (3, 6), (3, 12), (3, 18))):
            y = self.gct(f"{p}.{name}.GCT", x)
            y = self.conv(f"{p}.{name}.atrous_conv", y,
                          padding=0 if k == 1 else d, dilation=d)
            outs.append(F.relu(self.gn(f"{p}.{name}.bn", y, 32)))
        x5 = F.relu(self.conv(p + ".global_conv",
                              x.mean(dim=(2, 3), keepdim=True)))
        x5 = x5.expand(-1, -1, outs[0].shape[2], outs[0].shape[3])
        x = self.gct(p + ".GCT", torch.cat(outs + [x5], dim=1))
        return F.relu(self.gn(p + ".bn1", self.conv(p + ".conv1", x), 32))

    def modulator(self, prefix, x, mem, head):
        x = torch.cat([x, mem], dim=1)
        for i in (1, 2, 3):
            x = self.ia_gate(f"{prefix}_Reweight_Layer_{i}", x, head)
            x = self.gn_bottleneck(f"{prefix}_Bottleneck_{i}", x)
        return x

    def ia_logit(self, p, x, head):
        c = x.shape[1]
        out = self.linear(p, head)
        return (torch.einsum("ochw,oc->ohw", self.cast(x),
                             self.cast(out[:, :c])) + out[:, -1][:, None, None])

    def decode(self, x, head, low_level, ov, beta_pct, memory):
        """The calibration decoder → (logits [O, h, w], new memory).
        ``memory``: the two feature slots of the frames before, or None
        at a video's first decoded frame (both slots then read this
        frame's features); slot 0 is this frame's post-ASPP features,
        slot 1 sticks from its first assignment."""
        p = "dynamic_seghead"
        x = self.ia_gate(p + ".IA1", x, head)
        x = self.gn_bottleneck(p + ".layer1", x)
        x = self.cond_block(p + ".CLB2", x, head, ov, beta_pct)
        x = self.gn_bottleneck(p + ".layer2", x, 1, 2)
        x = self.cond_block(p + ".CLB3", x, head, ov, beta_pct)
        x = self.gn_bottleneck(p + ".layer3", x, 2)
        x = self.cond_block(p + ".CLB4", x, head, ov, beta_pct)
        x = self.gn_bottleneck(p + ".layer4", x, 1, 2)
        x = self.cond_block(p + ".CLB5", x, head, ov, beta_pct)
        x = self.gn_bottleneck(p + ".layer5", x, 1, 4)
        x = self.ia_gate(p + ".IA9", x,
                         torch.cat([head, inter_object_delta(x, ov)], dim=1))
        x = self.gn_aspp(p + ".ASPP", x)
        x_cur_1 = x.detach()            # the memory carries no gradient
        mem0 = x_cur_1 if memory is None else memory[0]
        x = self.modulator(p + ".M1", x, mem0, head)
        mem1 = x.detach() if memory is None else memory[1]
        x = self.modulator(p + ".M2", x, mem1, head)
        new_memory = (x_cur_1, mem1)

        x = F.interpolate(x, size=low_level.shape[2:], mode="bicubic",
                          align_corners=True)
        ll = self.gct(p + ".GCT_sc", low_level)
        ll = F.relu(self.gn(p + ".bn_sc", self.conv(p + ".conv_sc", ll),
                            self.sd[p + ".conv_sc.weight"].shape[0] // 4))
        x = torch.cat([x, ll.expand(x.shape[0], -1, -1, -1)], dim=1)
        x = self.ia_gate(p + ".IA10", x,
                         torch.cat([head, inter_object_delta(x, ov)], dim=1))
        x = F.relu(self.gn(p + ".bn1", self.conv(p + ".conv1", x, padding=1),
                           32))
        x = self.ia_gate(p + ".IA11", x,
                         torch.cat([head, inter_object_delta(x, ov)], dim=1))
        x = F.relu(self.gn(p + ".bn2", self.conv(p + ".conv2", x, padding=1),
                           32))
        fg = self.ia_logit(p + ".IA_final_fg", x, head)
        bg = self.ia_logit(p + ".IA_final_bg", x, head)
        # the absolute background gains the min of the valid objects'
        # relative-background logits
        valid = ov[1:] > 0
        aug = torch.where(valid[:, None, None], bg[1:],
                          torch.full_like(bg[1:], np.inf)).min(dim=0).values
        aug = torch.where(valid.any(), aug, torch.zeros_like(aug))
        return torch.cat([(fg[0] + aug)[None], fg[1:]], dim=0), new_memory

    # -- one frame ---------------------------------------------------------
    def segment(self, cfg: Dict, cur_emb, cur_low, bank_emb, bank_lab,
                bank_valid, flat_emb, flat_lab, prev_emb, prev_lab, ov,
                scores, memory):
        """One frame's logits against its bank and its previous frame.

        cur_emb, prev_emb [C, h, w]; cur_low [1, L, h, w]; bank_emb
        [S, C, h, w] and bank_lab [S, h, w] (int, 125 and other ids past
        O match nothing) with bank_valid [S]; flat_emb [P, C], flat_lab
        [P, O]: the compacted bank that the global and cluster streams
        read; prev_lab [h, w] int; ov [O] object validity; scores [O, P]
        k-means init draws; memory: the decoder's slots or None.
        Returns (logits [O, h, w], new memory)."""
        c, h, w = cur_emb.shape
        o = ov.shape[0]
        bias = torch.cat([self.sd["bg_bias"],
                          self.sd["fg_bias"].expand(o - 1)])
        q = cur_emb.permute(1, 2, 0).reshape(h * w, c)
        flat_lab = flat_lab * ov
        global_fg = self.global_matching(q, flat_emb, flat_lab, bias)
        global_cluster = self.cluster_matching(
            q, flat_emb, flat_lab, bias, scores, cfg["MODEL_CLUSTER_NUM"],
            cfg["MODEL_KMEANS_ITERS"])

        s = bank_emb.shape[0]
        ref_flat = bank_emb.permute(0, 2, 3, 1).reshape(s * h * w, c)
        ref_oh = one_hot(bank_lab, o).reshape(s * h * w, o) * ov
        prev_oh = one_hot(prev_lab, o) * ov                    # [h, w, O]
        ref_pos, ref_neg = self.pos_neg(
            ref_flat, ref_oh, bank_valid.float().repeat_interleave(h * w),
            cfg["MODEL_EPSILON"])
        p_flat = prev_emb.permute(1, 2, 0).reshape(h * w, c)
        prev_pos, prev_neg = self.pos_neg(
            p_flat, prev_oh.reshape(h * w, o),
            torch.ones(h * w, device=q.device), cfg["MODEL_EPSILON"])
        head = torch.cat([ref_pos, ref_neg, prev_pos, prev_neg], dim=1)
        global_proxy = self.proxy_matching(q, ref_pos, bias)
        prev_inst = (prev_oh.reshape(h * w, o) @ prev_pos).reshape(h, w, c)

        radii = tuple(cfg["MODEL_MULTI_LOCAL_DISTANCE"])
        cur_hwc = cur_emb.permute(1, 2, 0)
        local_fg = self.local_matching(cur_hwc, prev_emb.permute(1, 2, 0),
                                       prev_oh, bias, radii)
        local_proxy = self.local_matching(cur_hwc, prev_inst, prev_oh, bias,
                                          radii)
        parts = [global_fg.view(h, w, o, 1), global_cluster.view(h, w, o, 2),
                 global_proxy.view(h, w, o, 1), local_fg, local_proxy,
                 prev_oh[..., None]]
        if cfg["MODEL_MATCHING_BACKGROUND"]:
            parts.append(foreground2background(local_fg, ov))
            parts.append(foreground2background(global_fg.view(h, w, o, 1), ov))
        maps = torch.cat(parts, dim=-1).permute(2, 3, 0, 1)     # [O, n, h, w]
        pre = self.conv("dynamic_prehead.conv", maps)
        pre = F.relu(self.gn("dynamic_prehead.bn", pre,
                             cfg["MODEL_PRE_HEAD_EMBEDDING_DIM"] // 4))
        x = torch.cat([cur_emb[None].expand(o, -1, -1, -1), pre], dim=1)
        logits, memory = self.decode(x, head, cur_low, ov,
                                     cfg["MODEL_BETA_PERCENTAGE"], memory)
        logits = torch.where(ov[:, None, None] > 0, logits,
                             torch.full_like(logits, -1e9))
        return logits, memory


def squash(d, bias):
    """(sigmoid(d + bias) - 0.5) · 2, ``bias`` [O] on d's object axis: the
    last axis of [M, O], the one before it of [M, O, k]."""
    if d.dim() == 2:
        return (torch.sigmoid(d + bias[None]) - 0.5) * 2.0
    return (torch.sigmoid(d + bias[None, :, None]) - 0.5) * 2.0


def one_hot(lab: torch.Tensor, o: int) -> torch.Tensor:
    """float one-hot on a new last axis; ids outside [0, o) give zeros."""
    return (lab[..., None] == torch.arange(o, device=lab.device)).float()


def inter_object_delta(x, ov):
    """Per object, the sum of the OTHER valid objects' pooled features."""
    px = x.mean(dim=(2, 3)) * ov[:, None]
    return px.sum(0, keepdim=True) - px


def foreground2background(dis, ov):
    """[H, W, O, k] → per object the min over the other valid objects'
    maps (1.0 where none); one valid object or none: unchanged."""
    o = dis.shape[2]
    valid = ov > 0
    if int(valid.sum()) <= 1:
        return dis
    outs = []
    for i in range(o):
        others = [dis[:, :, j] for j in range(o) if j != i and bool(valid[j])]
        m = torch.stack(others, dim=2).min(dim=2).values
        outs.append(torch.minimum(m, torch.ones_like(m)))
    return torch.stack(outs, dim=2)
