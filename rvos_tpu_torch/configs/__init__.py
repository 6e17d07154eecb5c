from .base import Config
from .presets import BANK_LAYOUTS, PRESETS, get_config, resnet101_aocnet, resnet101_aocnet_2, tiny_test

__all__ = [
    "BANK_LAYOUTS",
    "Config",
    "PRESETS",
    "get_config",
    "resnet101_aocnet",
    "resnet101_aocnet_2",
    "tiny_test",
]
