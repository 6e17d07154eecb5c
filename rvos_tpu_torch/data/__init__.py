from .datasets import SyntheticEval
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, eval_variants,
                         frame_u8, restrict_size, snap_16)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "SyntheticEval",
           "eval_variants", "frame_u8", "restrict_size", "snap_16"]
