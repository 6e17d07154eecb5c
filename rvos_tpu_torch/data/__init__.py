from .datasets import DAVISTest, SyntheticEval, VOSTestSeq, YTBVOSTest
from .loader import PrefetchLoader
from .perturb import get_perturbation
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, eval_variants,
                         frame_u8, restrict_size, snap_16)

__all__ = ["DAVISTest", "IMAGENET_MEAN", "IMAGENET_STD", "PrefetchLoader",
           "SyntheticEval", "VOSTestSeq", "YTBVOSTest", "eval_variants",
           "frame_u8", "get_perturbation", "restrict_size", "snap_16"]
