"""AOC-Net — adaptive object proxies + conditional mask calibration
(PyTorch port of ``rvos_tpu/models/aocnet.py``): the inference path
and, with ``segment_frame(..., train=True)``, the training route.

Public methods keep the JAX package's layouts (``[h, w, C]`` embeddings,
``[..., O]`` one-hot labels); inside, the modules run NCHW with the
object axis as the batch.

Matching-map concat order:
  global_fg(1) | global_cluster(2) | global_proxy(1) | local_fg(n) |
  local_proxy(n) | prev_mask(1) | [local_bg(n) | global_bg(1)]
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs import Config
from ..ops import (attention_heads, cluster_matching, cluster_objects,
                   foreground2background, local_matching_bank_stacked,
                   proxy_matching, proxy_reconstructed_embedding)
from ..ops.matching import (compact_reference_bank,
                            compact_reference_bank_occupancy,
                            compact_reference_bank_segmented, flat_bank,
                            global_matching_flat,
                            global_matching_flat_segmented, squash_distance)
from ..ops.train_matching import global_matching_min, local_matching_min
from .decoder import CalibrationDecoding, DecoderMemory
from .deeplab import BACKBONES, DeepLab
from .layers import GN, DynamicPreHead


class SemanticEmbedding(nn.Module):
    """Depthwise 3×3 + GN + 1×1 (256→emb) + GN."""

    def __init__(self, aspp_dim: int = 256, embedding_dim: int = 100,
                 gn_groups: int = 32, gn_emb_groups: int = 25):
        super().__init__()
        self.seperate_conv = nn.Conv2d(aspp_dim, aspp_dim, 3, padding=1,
                                       groups=aspp_dim)
        self.bn1 = GN(gn_groups, aspp_dim)
        self.embedding_conv = nn.Conv2d(aspp_dim, embedding_dim, 1)
        self.bn2 = GN(gn_emb_groups, embedding_dim)

    def forward(self, x):
        x = torch.relu(self.bn1(self.seperate_conv(x)))
        return torch.relu(self.bn2(self.embedding_conv(x)))


class AOCNet(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.feature_extracter = DeepLab(c.MODEL_OUTPUT_STRIDE,
                                         c.MODEL_BACKBONE,
                                         c.MODEL_ASPP_DROPOUT)
        self.semantic_embedding = SemanticEmbedding(
            c.MODEL_ASPP_OUTDIM, c.MODEL_SEMANTIC_EMBEDDING_DIM,
            c.MODEL_GN_GROUPS, c.MODEL_GN_EMB_GROUPS)
        self.bg_bias = nn.Parameter(torch.zeros(1))
        self.fg_bias = nn.Parameter(torch.zeros(1))
        self.dynamic_prehead = DynamicPreHead(c.prehead_in_dim,
                                              c.MODEL_PRE_HEAD_EMBEDDING_DIM)
        # the low-level width comes from the backbone (MobileNet's is 24);
        # the config field overrides ResNet's only, as in the JAX package
        if (c.MODEL_BACKBONE == "mobilenet"
                and c.MODEL_LOW_LEVEL_INPLANES not in (256, 24)):
            raise ValueError(
                "MODEL_LOW_LEVEL_INPLANES is derived from the backbone "
                "(mobilenet low-level features are 24-wide); the config "
                f"override {c.MODEL_LOW_LEVEL_INPLANES} would be silently "
                "ignored")
        low_level_dim = (BACKBONES["mobilenet"][2]
                         if c.MODEL_BACKBONE == "mobilenet"
                         else c.MODEL_LOW_LEVEL_INPLANES)
        self.dynamic_seghead = CalibrationDecoding(
            in_dim=c.MODEL_SEMANTIC_EMBEDDING_DIM + c.MODEL_PRE_HEAD_EMBEDDING_DIM,
            attention_dim=c.attention_head_dim,
            embed_dim=c.MODEL_HEAD_EMBEDDING_DIM,
            refine_dim=c.MODEL_REFINE_CHANNELS,
            low_level_dim=low_level_dim,
            beta_percentage=c.MODEL_BETA_PERCENTAGE)

    # ------------------------------------------------------------------
    def extract_feature(self, imgs: torch.Tensor, generator=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] → (embedding [N, h4, w4, emb], low-level
        [N, h4, w4, 256 or 24]).  ``generator`` (a ``torch.Generator`` or
        ``deeplab.BatchDraws``) draws the ASPP dropout mask (training);
        without one the dropout is the identity."""
        feats, low = self.feature_extracter(imgs.permute(0, 3, 1, 2),
                                            generator)
        emb = self.semantic_embedding(feats)
        return emb.permute(0, 2, 3, 1), low.permute(0, 2, 3, 1)

    def dis_bias(self, n_obj: int) -> torch.Tensor:
        """[O] distance bias: background slot 0, foreground elsewhere."""
        return torch.cat([self.bg_bias, self.fg_bias.expand(n_obj - 1)])

    # ------------------------------------------------------------------
    def segment_frame(
        self,
        current_emb: torch.Tensor,     # [h, w, C]
        current_low: torch.Tensor,     # [h, w, 256 or 24]
        ref_emb_bank: torch.Tensor,    # [S, h, w, C]
        ref_onehot: torch.Tensor,      # [S, h, w, O]
        slot_valid: torch.Tensor,      # [S]
        prev_emb: torch.Tensor,        # [h, w, C]
        prev_onehot: torch.Tensor,     # [h, w, O]
        obj_valid: torch.Tensor,       # [O]
        memory: DecoderMemory,
        kmeans_scores: torch.Tensor,   # [O, R] k-means init draws
        flat_emb: Optional[torch.Tensor] = None,   # [P, C] precompacted bank
        flat_lab: Optional[torch.Tensor] = None,   # [P, O]
        flat_obj: Optional[torch.Tensor] = None,   # [n_tiles] tile→object
        train: bool = False,
        cp_devices: Optional[Sequence[torch.device]] = None,
    ) -> Tuple[torch.Tensor, DecoderMemory]:
        """One frame's matching + calibration decode → logits [O, h, w].

        The global stream takes the JAX package's TPU route.  A
        precompacted label-segmented bank (``MATCHING_SEGMENTED_BANK``
        with a non-zero cap) runs through kernel 1: the occupancy layout
        (``flat_obj`` set) as B.1, the uniform-quota layout as B.2.  Any
        other bank — no cap, the fg-union compaction, or the bank
        flattened (and fg-compacted) here when none is precompacted —
        runs through kernel 3 (B.3).  ``kmeans_scores`` has one row of
        ``R`` draws per object, ``R`` the rows of the flat bank.

        ``cp_devices`` (``parallel.mesh.resolved_cp_devices``): context
        parallelism — global, cluster and proxy matching split their
        query rows over these devices, each shard on the flat route (B.3,
        or ``GlobalMatchingMin`` in training), whatever the bank's layout,
        as the JAX package sends every context-parallel bank to its flat
        route; local matching is not split."""
        c = self.cfg
        h, w, _ = current_emb.shape
        o = ref_onehot.shape[-1]
        bias = self.dis_bias(o).float()
        mdt = c.matching_dtype
        dtype = torch.bfloat16 if mdt == "bfloat16" else torch.float32
        mixed = mdt in ("mixed", "bfloat16")
        op_dtype = current_emb.dtype if mixed else dtype
        ov = obj_valid.to(ref_onehot.dtype)

        ref_onehot = ref_onehot * ov
        prev_onehot = prev_onehot * ov

        seg_bank = False
        if train and flat_emb is not None:
            raise ValueError("the training route flattens its own bank")
        if flat_emb is None:
            g = c.TRAIN_GLOBAL_ATROUS_RATE if train else c.TEST_GLOBAL_ATROUS_RATE
            flat_emb, flat_lab = flat_bank(ref_emb_bank[:, ::g, ::g],
                                           ref_onehot[:, ::g, ::g], slot_valid)
            if c.MATCHING_MAX_REF_PIXELS:
                flat_emb, flat_lab = compact_reference_bank(
                    flat_emb, flat_lab, c.MATCHING_MAX_REF_PIXELS)
        else:
            flat_lab = flat_lab * ov.to(flat_lab.dtype)
            seg_bank = (c.MATCHING_SEGMENTED_BANK
                        and bool(c.MATCHING_MAX_REF_PIXELS))

        # 1. global pixel matching
        cp = cp_devices
        if train:
            d_min = global_matching_min(
                current_emb.reshape(h * w, -1).to(dtype), flat_emb.to(dtype),
                flat_lab.to(dtype), devices=cp)
            global_fg = squash_distance(d_min.reshape(h, w, o)[..., None],
                                        bias)
        elif seg_bank and cp is None:
            global_fg = global_matching_flat_segmented(
                current_emb, flat_emb.to(dtype), flat_lab.to(dtype), bias,
                flat_obj, dtype=dtype, mixed=mixed)
        else:
            global_fg = global_matching_flat(
                current_emb, flat_emb.to(dtype), flat_lab.to(dtype), bias,
                dtype=dtype, mixed=mixed, devices=cp)

        # 2. AOP cluster matching, on detached inputs (no gradient
        # reaches the bank through 20 Lloyd iterations)
        with torch.no_grad():
            banks = cluster_objects(flat_emb.detach(), flat_lab.detach(),
                                    kmeans_scores, k=c.MODEL_CLUSTER_NUM,
                                    iters=c.MODEL_KMEANS_ITERS, mixed=mixed)
        global_cluster = cluster_matching(current_emb, banks, bias,
                                          dtype=dtype, devices=cp)

        # 3+4. instance proxies, then both local matchings in one launch
        heads = attention_heads(ref_emb_bank, ref_onehot, slot_valid,
                                prev_emb, prev_onehot, c.MODEL_EPSILON)
        global_proxy = proxy_matching(current_emb, heads.ref_pos, bias,
                                      dtype=dtype, devices=cp)
        prev_inst = proxy_reconstructed_embedding(prev_onehot, heads.prev_pos)
        local_pair = local_matching_bank_stacked(
            current_emb, torch.stack([prev_emb, prev_inst.to(prev_emb.dtype)]),
            prev_onehot, bias, c.MODEL_MULTI_LOCAL_DISTANCE,
            atrous_rate=(c.TRAIN_LOCAL_ATROUS_RATE if train
                         else c.TEST_LOCAL_ATROUS_RATE),
            allow_downsample=c.MODEL_LOCAL_DOWNSAMPLE, dtype=op_dtype,
            match=local_matching_min if train else None)
        local_fg, local_proxy = local_pair[0], local_pair[1]

        # 5. concat in reference channel order
        parts = [global_fg, global_cluster, global_proxy, local_fg,
                 local_proxy, prev_onehot.float()[..., None]]
        if c.MODEL_MATCHING_BACKGROUND:
            parts.append(foreground2background(local_fg, obj_valid))
            parts.append(foreground2background(global_fg, obj_valid))
        maps = torch.cat(parts, dim=-1)                     # [h, w, O, n]
        maps = maps.permute(2, 3, 0, 1).to(current_emb.dtype)

        # 6. prehead + decoder
        pre = self.dynamic_prehead(maps)
        cur = current_emb.permute(2, 0, 1)[None].expand(o, -1, -1, -1)
        x = torch.cat([cur, pre], dim=1)
        head = heads.total_head.to(current_emb.dtype)
        logits, new_memory = self.dynamic_seghead(
            x, head, memory, current_low.permute(2, 0, 1)[None],
            obj_valid.to(current_emb.dtype))
        logits = torch.where(obj_valid[:, None, None].bool(), logits,
                             torch.full_like(logits, -1e9))
        return logits, new_memory


def precompact_bank(cfg: Config, ref_emb_bank: torch.Tensor,
                    ref_onehot: torch.Tensor, slot_valid: torch.Tensor):
    """Flatten + compaction of the eval reference bank, run by the
    evaluator only when the bank or the object set changes.  Returns
    ``(flat_emb [P, C], flat_lab [P, O], tile_obj)``; ``tile_obj`` is
    the occupancy layout's tile→object map, None for the uniform-quota
    and unsegmented layouts."""
    g = cfg.TEST_GLOBAL_ATROUS_RATE
    flat_emb, flat_lab = flat_bank(ref_emb_bank[:, ::g, ::g],
                                   ref_onehot[:, ::g, ::g], slot_valid)
    if not cfg.MATCHING_MAX_REF_PIXELS:
        return flat_emb, flat_lab, None
    if cfg.MATCHING_SEGMENTED_BANK and cfg.MATCHING_OCCUPANCY_BANK:
        return compact_reference_bank_occupancy(
            flat_emb, flat_lab, cfg.MATCHING_MAX_REF_PIXELS)
    compact = (compact_reference_bank_segmented
               if cfg.MATCHING_SEGMENTED_BANK else compact_reference_bank)
    flat_emb, flat_lab = compact(flat_emb, flat_lab,
                                 cfg.MATCHING_MAX_REF_PIXELS)
    return flat_emb, flat_lab, None
