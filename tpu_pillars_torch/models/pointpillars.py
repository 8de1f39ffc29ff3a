"""PointPillars model: the PillarFeatureNet, the RPN and the SSD head.

Port of ``tpu_pillars/models/pointpillars.py``. The module holds the
weights (``models.pfn``, ``models.backbone``, ``models.head``) and runs the
dense part; the front end (sort, K1 emit, K2 fused PFN, K3 scatter) lives
in ``ops``. :meth:`PointPillars.forward` is the flax ``__call__`` at
inference: a classic ``PillarBatch`` in (``ops.emit.pillarize_batch_emit``),
the PillarFeatureNet on its running statistics, K3, the RPN and the
anchor-major head. Weights and BatchNorm affines are trainable
parameters; serving runs them under ``torch.no_grad()``. BatchNorm running
statistics are buffers.

TF32: a float32 convolution goes through cuDNN in TF32 by default, and the
JAX reference runs in full f32. :func:`full_fp32` turns TF32 off for
cuDNN and cuBLAS for the span of a call and restores the caller's settings.

bf16: the dense part takes a ``dtype`` (float32 or bfloat16) with flax's
cast points (``PointPillars(dtype=)`` and ``detector._wire_head(dtype=)``
in the JAX package): the convs, the head matmuls and the PillarFeatureNet's
linear layer run on ``dtype`` views of the f32 weights, BatchNorm
normalises in f32 and returns ``dtype``; the wire and feature-major heads
return f32, the anchor-major head ``dtype`` (flax's ``SSDHead``).
:func:`full_fp32` wraps the float32 path only (TF32 does not touch bf16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.models.backbone import (  # noqa: F401 (re-exported)
    RPNBackbone, full_fp32, precision,
)
from tpu_pillars_torch.models.head import SSDHead
from tpu_pillars_torch.models.pfn import PillarFeatureNet
from tpu_pillars_torch.ops.bev import scatter_to_bev_auto
from tpu_pillars_torch.ops.voxelize import PillarBatch


class ModelOutputs(NamedTuple):
    cls_logits: torch.Tensor   # (B, A, num_classes)
    box_deltas: torch.Tensor   # (B, A, 7)
    dir_logits: torch.Tensor   # (B, A, 2)


def remat_flags(remat) -> tuple:
    """Normalize the remat knob to (checkpoint_pfn, checkpoint_rpn):
    True/"all" both tiers, "pfn" or "rpn" one, False/"off"/None neither."""
    if remat is None or remat == "off" or remat is False:
        return False, False
    if remat == "pfn":
        return True, False
    if remat == "rpn":
        return False, True
    if remat is True or remat == "all":
        return True, True
    raise ValueError(f"remat must be bool, 'all', 'pfn', 'rpn' or 'off'; "
                     f"got {remat!r}")


class PointPillars(nn.Module):
    """Weights of the detector; load with ``weights.params_from_flax``, save
    with ``weights.flax_from_params``. The training forward is
    ``train.step``'s: the PFN through ``ops.fused_pfn`` (fused front end)
    or :meth:`train_canvas_from_batch` (classic), then
    :meth:`train_features_from_canvas` and :meth:`SSDHead.feature_major`."""

    def __init__(self, config: PillarsConfig):
        super().__init__()
        self.config = config
        self.pfn = PillarFeatureNet(config.num_decorated_features,
                                    config.pfn_channels)
        self.rpn = RPNBackbone(config.pfn_channels, config.rpn_channels,
                               config.rpn_layers, config.rpn_up_channels)
        self.head = SSDHead(3 * config.rpn_up_channels, config.num_classes,
                            config.anchors_per_loc)

    def forward(self, batch: PillarBatch, dtype=torch.float32
                ) -> ModelOutputs:
        """The flax ``PointPillars.__call__`` at inference: a batched
        ``PillarBatch`` -> anchor-major :class:`ModelOutputs` in
        ``dtype``."""
        return self.detect_from_canvas(self.canvas_from_batch(batch, dtype),
                                       dtype)

    def canvas_from_batch(self, batch: PillarBatch, dtype=torch.float32):
        """PFN (running statistics) + K3: (B, P, N, D) pillars -> (B, H, W,
        C) canvas in ``dtype``."""
        feats = self.pfn(batch.features, batch.mask, dtype)
        return scatter_to_bev_auto(feats, batch.coords, batch.pillar_mask,
                                   self.config, dtype)

    def train_canvas_from_batch(self, batch: PillarBatch, remat: bool = False,
                                dtype=torch.float32, mesh=None):
        """The training twin of :meth:`canvas_from_batch`: the PFN on batch
        statistics (checkpointed when ``remat``; over ``mesh``'s ranks when
        given) and K3 with its row-gather backward -> (canvas in ``dtype``,
        mean, var), the PFN's f32 moments for the caller's
        running-statistics update. The caller holds ``full_fp32`` across
        forward and backward."""
        def pfn(features, mask):
            return self.pfn.train_forward(features, mask, dtype, mesh)

        feats, mean, var = (
            checkpoint(pfn, batch.features, batch.mask, use_reentrant=False)
            if remat else pfn(batch.features, batch.mask))
        canvas = scatter_to_bev_auto(feats, batch.coords, batch.pillar_mask,
                                     self.config, dtype)
        return canvas, mean, var

    def detect_from_canvas(self, canvas, dtype=torch.float32) -> ModelOutputs:
        """RPN + anchor-major head: canvas -> :class:`ModelOutputs`."""
        feat = self.features_from_canvas(canvas, dtype)
        with precision(dtype):
            return ModelOutputs(*self.head(feat, dtype))

    def features_from_batch(self, batch: PillarBatch, dtype=torch.float32):
        """PFN + K3 + RPN: pillars -> (B, H/2, W/2, C_feat) feature map."""
        return self.features_from_canvas(
            self.canvas_from_batch(batch, dtype), dtype)

    def features_from_canvas(self, canvas, dtype=torch.float32):
        """(B, H, W, C_in) canvas -> (B, H/2, W/2, C_feat) feature map in
        ``dtype``."""
        x = canvas.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with precision(dtype):
            return self.rpn(x, dtype).permute(0, 2, 3, 1).contiguous()

    def train_features_from_canvas(self, canvas, remat: bool = False,
                                   dtype=torch.float32, mesh=None):
        """Batch-statistics RPN: canvas -> (feature map (B, H/2, W/2,
        C_feat) in ``dtype``, one f32 (mean, var) per
        ``self.rpn.batch_norms()``, over ``mesh``'s ranks when given). The
        caller holds ``full_fp32`` across forward and backward."""
        x = canvas.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feat, moments = self.rpn.train_forward(x, remat=remat, dtype=dtype,
                                               mesh=mesh)
        return feat.permute(0, 2, 3, 1), moments

    def wire_head(self, feat, dtype=torch.float32):
        with precision(dtype):
            return self.head.wire(feat, dtype)
