"""PointPillars serving model: folded PFN weights, RPN, and the wire head.

Port of the serving parts of ``tpu_pillars/models/pointpillars.py``
(``features_from_canvas``) and ``tpu_pillars/detector.py`` (``_wire_head``).
The front end (sort, K1 emit, K2 fused PFN, K3 scatter) lives in
``ops``; this module holds the weights and runs the dense part.

TF32: a float32 convolution goes through cuDNN in TF32 by default, and the
JAX reference runs in full f32. :func:`full_fp32` turns TF32 off for
cuDNN and cuBLAS for the span of a call and restores the caller's settings.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.models.backbone import FrozenBatchNorm, RPNBackbone
from tpu_pillars_torch.ops.fused_pfn import fold_bn


@contextlib.contextmanager
def full_fp32():
    """No TF32 in cuDNN convolutions or cuBLAS matmuls inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class PFNWeights(nn.Module):
    """The PillarFeatureNet's linear kernel (D, C) and BatchNorm; serving
    only needs them folded (:meth:`folded`)."""

    def __init__(self, in_dim: int, channels: int):
        super().__init__()
        self.register_buffer("kernel", torch.zeros(in_dim, channels))
        self.bn = FrozenBatchNorm(channels)

    def folded(self):
        bn = self.bn
        return fold_bn(self.kernel, bn.weight, bn.bias, bn.running_mean,
                       bn.running_var)


class WireHead(nn.Module):
    """The SSD head's three 1x1 convs as matmuls emitting the serving wire:
    own (B, A) own-class logits in CANONICAL anchor order (a = hw * A_loc +
    a_loc); box_p (B, 7, A) and dir_p (B, 2, A) feature-major in the
    PERMUTED order (a'' = a_loc * HW + hw). Kernels keep flax's (C, A_loc*k)
    layout (column = a_loc * k + feature)."""

    def __init__(self, feat_ch: int, num_classes: int, anchors_per_loc: int):
        super().__init__()
        self.k = num_classes
        self.a_loc = anchors_per_loc
        for name, width in (("cls", num_classes), ("box", 7), ("dir", 2)):
            lin = nn.Module()
            lin.register_buffer("weight",
                                torch.zeros(feat_ch, anchors_per_loc * width))
            lin.register_buffer("bias", torch.zeros(anchors_per_loc * width))
            self.add_module(name, lin)
        a_loc = anchors_per_loc
        # own-class channel of anchor a_loc: class a_loc // 2 (2 yaws each)
        self.register_buffer("own_ch", torch.tensor(
            [al * num_classes + al // 2 for al in range(a_loc)]),
            persistent=False)

        def colperm(k_dim):
            # new column (k * A_loc + a_loc) <- old column (a_loc * k + k)
            k = np.arange(k_dim)[:, None]
            al = np.arange(a_loc)[None, :]
            return torch.from_numpy((al * k_dim + k).reshape(-1))

        self.register_buffer("perm_box", colperm(7), persistent=False)
        self.register_buffer("perm_dir", colperm(2), persistent=False)

    def forward(self, feat):
        """feat (B, Hf, Wf, C) -> (own, box_p, dir_p), f32."""
        B, hf, wf, c = feat.shape
        hw = hf * wf
        a = hw * self.a_loc
        f = feat.reshape(B, hw, c)
        own = (f @ self.cls.weight[:, self.own_ch]
               + self.cls.bias[self.own_ch])
        ft = f.transpose(1, 2)                                 # (B, C, HW)
        box_p = (self.box.weight[:, self.perm_box].t() @ ft
                 + self.box.bias[self.perm_box][:, None])
        dir_p = (self.dir.weight[:, self.perm_dir].t() @ ft
                 + self.dir.bias[self.perm_dir][:, None])
        return (own.reshape(B, a), box_p.reshape(B, 7, a),
                dir_p.reshape(B, 2, a))


class PointPillars(nn.Module):
    """Serving weights of the detector; load with ``weights.params_from_
    flax``. Inference only (frozen BatchNorm, no gradients)."""

    def __init__(self, config: PillarsConfig):
        super().__init__()
        self.config = config
        self.pfn = PFNWeights(config.num_decorated_features,
                              config.pfn_channels)
        self.rpn = RPNBackbone(config.pfn_channels, config.rpn_channels,
                               config.rpn_layers, config.rpn_up_channels)
        self.head = WireHead(3 * config.rpn_up_channels, config.num_classes,
                             config.anchors_per_loc)

    def features_from_canvas(self, canvas):
        """(B, H, W, C_in) canvas -> (B, H/2, W/2, C_feat) feature map."""
        x = canvas.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with full_fp32():
            return self.rpn(x).permute(0, 2, 3, 1).contiguous()

    def wire_head(self, feat):
        with full_fp32():
            return self.head(feat)
