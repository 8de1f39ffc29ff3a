"""The port's dense model: the PillarFeatureNet, the RPN backbone and the
SSD head."""

from tpu_pillars_torch.models.backbone import RPNBackbone
from tpu_pillars_torch.models.head import HeadOutputs, SSDHead
from tpu_pillars_torch.models.pfn import MaskedBatchNorm, PillarFeatureNet
from tpu_pillars_torch.models.pointpillars import ModelOutputs, PointPillars

__all__ = [
    "PointPillars", "ModelOutputs", "PillarFeatureNet", "MaskedBatchNorm",
    "RPNBackbone", "SSDHead", "HeadOutputs",
]
