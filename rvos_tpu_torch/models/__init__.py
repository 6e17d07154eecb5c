from .aocnet import AOCNet, SemanticEmbedding, precompact_bank
from .decoder import CalibrationDecoding, DecoderMemory
from .deeplab import DeepLab, DeepLabASPP, DeepLabDecoder
from .layers import (GCT, ConditioningBlock, ConditioningLayer,
                     DynamicPreHead, GNASPP, GNBottleneck, IAGate)
from .resnet import FrozenBatchNorm2d, ResNet101

__all__ = [
    "AOCNet",
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
    "precompact_bank",
]
