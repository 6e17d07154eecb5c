from .datasets import (DAVISTest, DAVISTrain, SyntheticEval, SyntheticTrain,
                       VOSTestSeq, VOSTrain, YTBVOSTest, YTBVOSTrain)
from .loader import PrefetchLoader, TrainBatcher
from .perturb import get_perturbation
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, balanced_random_crop,
                         eval_variants, frame_u8, normalize, random_hflip,
                         random_scale, restrict_size, snap_16)

__all__ = ["DAVISTest", "DAVISTrain", "IMAGENET_MEAN", "IMAGENET_STD",
           "PrefetchLoader", "SyntheticEval", "SyntheticTrain",
           "TrainBatcher", "VOSTestSeq", "VOSTrain", "YTBVOSTest",
           "YTBVOSTrain", "balanced_random_crop", "eval_variants",
           "frame_u8", "get_perturbation", "normalize", "random_hflip",
           "random_scale", "restrict_size", "snap_16"]
