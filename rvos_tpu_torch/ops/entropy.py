"""Shannon-entropy uncertainty for the RPA confident-mask filter (PyTorch
port of ``rvos_tpu/ops/entropy.py``): non-existing channels are zeroed
by a class mask, and a zero probability adds 0 to −Σ p·log(p + 1e-6)."""

from __future__ import annotations

import torch


def shannon_entropy(probs: torch.Tensor, class_mask: torch.Tensor
                    ) -> torch.Tensor:
    """probs [..., O, H, W]; class_mask [O] → [..., H, W]."""
    p = probs * class_mask[..., :, None, None]
    return -(p * torch.log(p + 1e-6)).sum(dim=-3)
