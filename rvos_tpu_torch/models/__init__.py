from ..configs import AOTConfig
from .aocnet import AOCNet, SemanticEmbedding, precompact_bank
from .aot import AOT
from .decoder import CalibrationDecoding, DecoderMemory
from .deeplab import DeepLab, DeepLabASPP, DeepLabDecoder
from .layers import (GCT, ConditioningBlock, ConditioningLayer,
                     DynamicPreHead, GNASPP, GNBottleneck, IAGate)
from .resnet import FrozenBatchNorm2d, ResNet101


def build_model(cfg):
    """The network ``cfg`` configures: ``AOT`` for an ``AOTConfig``, else
    ``AOCNet``."""
    return AOT(cfg) if isinstance(cfg, AOTConfig) else AOCNet(cfg)


__all__ = [
    "AOCNet",
    "AOT",
    "CalibrationDecoding",
    "ConditioningBlock",
    "ConditioningLayer",
    "DecoderMemory",
    "DeepLab",
    "DeepLabASPP",
    "DeepLabDecoder",
    "DynamicPreHead",
    "FrozenBatchNorm2d",
    "GCT",
    "GNASPP",
    "GNBottleneck",
    "IAGate",
    "ResNet101",
    "SemanticEmbedding",
    "build_model",
    "precompact_bank",
]
