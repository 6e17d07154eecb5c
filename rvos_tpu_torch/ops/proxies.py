"""Instance-level object representations (masked global-average pools);
PyTorch port of ``rvos_tpu/ops/proxies.py``.

Outputs the 400-d attention head [ref_pos | ref_neg | prev_pos |
prev_neg] per object plus the four component proxies.  The eval
variants sum numerators/denominators across the whole reference bank,
which is a masked GAP over the concatenated (slot-padded) bank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AttentionHeads(NamedTuple):
    total_head: torch.Tensor   # [O, 4C]
    ref_pos: torch.Tensor      # [O, C]
    ref_neg: torch.Tensor      # [O, C]
    prev_pos: torch.Tensor     # [O, C]
    prev_neg: torch.Tensor     # [O, C]


def _masked_pos_neg(emb, onehot, valid_px, epsilon):
    """emb [N, C]; onehot [N, O]; valid_px [N] → pos/neg means [O, C]."""
    lab = onehot * valid_px[:, None]
    pos_sum = lab.T @ emb
    pos_num = lab.sum(0)[:, None]
    tot_sum = (emb * valid_px[:, None]).sum(0)[None, :]
    tot_num = valid_px.sum()
    pos = pos_sum / (pos_num + epsilon)
    neg = (tot_sum - pos_sum) / (tot_num - pos_num + epsilon)
    return pos, neg


def attention_heads(ref_emb: torch.Tensor, ref_onehot: torch.Tensor,
                    slot_valid: torch.Tensor, prev_emb: torch.Tensor,
                    prev_onehot: torch.Tensor, epsilon: float = 1e-5
                    ) -> AttentionHeads:
    """ref_emb [S, H, W, C]; ref_onehot [S, H, W, O]; slot_valid [S];
    prev_emb [H, W, C]; prev_onehot [H, W, O]."""
    s, h, w, c = ref_emb.shape
    o = ref_onehot.shape[-1]
    r_val = slot_valid.float().repeat_interleave(h * w)
    ref_pos, ref_neg = _masked_pos_neg(
        ref_emb.reshape(-1, c).float(), ref_onehot.reshape(-1, o).float(),
        r_val, epsilon)
    p_val = torch.ones(h * w, dtype=torch.float32, device=prev_emb.device)
    prev_pos, prev_neg = _masked_pos_neg(
        prev_emb.reshape(-1, c).float(), prev_onehot.reshape(-1, o).float(),
        p_val, epsilon)
    total = torch.cat([ref_pos, ref_neg, prev_pos, prev_neg], dim=1)
    return AttentionHeads(total, ref_pos, ref_neg, prev_pos, prev_neg)


def proxy_reconstructed_embedding(prev_onehot: torch.Tensor,
                                  prev_pos: torch.Tensor) -> torch.Tensor:
    """Each previous-frame pixel's embedding replaced by its object's
    proxy: [H, W, O] · [O, C] → [H, W, C]."""
    return torch.einsum("hwo,oc->hwc", prev_onehot.float(), prev_pos)
