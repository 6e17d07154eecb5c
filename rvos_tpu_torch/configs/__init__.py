from .base import AOTConfig, Config
from .presets import (BANK_LAYOUTS, PRESETS, aotl_mobilenetv2, get_config,
                      resnet101_aocnet, resnet101_aocnet_2, tiny_test)

__all__ = [
    "AOTConfig",
    "BANK_LAYOUTS",
    "Config",
    "PRESETS",
    "aotl_mobilenetv2",
    "get_config",
    "resnet101_aocnet",
    "resnet101_aocnet_2",
    "tiny_test",
]
