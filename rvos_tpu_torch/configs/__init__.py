from .base import Config
from .presets import PRESETS, get_config, resnet101_aocnet, resnet101_aocnet_2, tiny_test

__all__ = [
    "Config",
    "PRESETS",
    "get_config",
    "resnet101_aocnet",
    "resnet101_aocnet_2",
    "tiny_test",
]
