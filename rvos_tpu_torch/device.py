"""Device resolution and the float32 precision policy.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise instead of carrying on
quietly on the CPU.

TF32: on Hopper a float32 convolution runs through cuDNN in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), keeping about
three decimal digits.  Matching distances use the Gram expansion
``‖q‖² + ‖r‖² − 2 q·r``, which cancels catastrophically below float32,
so parity mode (``MATCHING_DTYPE="float32"`` and
``EVAL_COMPUTE_DTYPE="float32"``) turns TF32 off for both matmuls and
convolutions.  Outside parity mode only convolutions may use it; plain
matmuls stay full float32 always.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

from .configs import Config


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA card; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def is_parity(cfg: Config) -> bool:
    return (cfg.matching_dtype == "float32"
            and cfg.EVAL_COMPUTE_DTYPE == "float32")


def configure_precision(cfg: Config) -> None:
    """Set both TF32 switches explicitly for ``cfg``'s precision mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = not is_parity(cfg)


@contextlib.contextmanager
def tf32_off():
    """Both TF32 switches off inside the block (a card-against-CPU
    comparison), and as they were again after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compute_dtype(cfg: Config, device: torch.device) -> torch.dtype:
    """Eval compute dtype: bfloat16 on the accelerator when the config
    asks for it (the JAX evaluator does the same on its TPU), float32
    otherwise."""
    if cfg.EVAL_COMPUTE_DTYPE == "bfloat16" and device.type == "cuda":
        return torch.bfloat16
    return torch.float32
