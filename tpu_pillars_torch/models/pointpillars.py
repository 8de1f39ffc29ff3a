"""PointPillars model: PFN weights, RPN, and the SSD head as matmuls.

Port of ``tpu_pillars/models/pointpillars.py`` (``features_from_canvas``),
``tpu_pillars/detector.py`` (``_wire_head``, the serving wire) and
``tpu_pillars/models/head.py`` (``feature_major_head``, the training head).
The front end (sort, K1 emit, K2 fused PFN, K3 scatter) lives in
``ops``; this module holds the weights and runs the dense part. Weights
and BatchNorm affines are trainable parameters; serving runs them under
``torch.no_grad()``. BatchNorm running statistics are buffers.

TF32: a float32 convolution goes through cuDNN in TF32 by default, and the
JAX reference runs in full f32. :func:`full_fp32` turns TF32 off for
cuDNN and cuBLAS for the span of a call and restores the caller's settings.

bf16: the dense part takes a ``dtype`` (float32 or bfloat16) with flax's
cast points (``PointPillars(dtype=)`` and ``detector._wire_head(dtype=)``
in the JAX package): the convs, the head matmuls and the PillarFeatureNet's
linear layer run on ``dtype`` views of the f32 weights, BatchNorm
normalises in f32 and returns ``dtype``, and the heads return f32.
:func:`full_fp32` wraps the float32 path only (TF32 does not touch bf16).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.models.backbone import BN_EPS, BatchNorm, RPNBackbone
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


def precision(dtype):
    """:func:`full_fp32` for float32, nothing for bfloat16."""
    if dtype == torch.float32:
        return full_fp32()
    if dtype == torch.bfloat16:
        return contextlib.nullcontext()
    raise TypeError(f"compute dtype must be float32 or bfloat16, got {dtype}")


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


class PFNWeights(nn.Module):
    """The PillarFeatureNet's linear kernel (D, C) and BatchNorm. Serving
    runs them folded (:meth:`folded`, for the K2 and K6 kernels) or as the
    flax module computes them (:meth:`forward`)."""

    def __init__(self, in_dim: int, channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, channels))
        self.bn = BatchNorm(channels)

    def forward(self, features, mask, dtype=torch.float32):
        """The flax ``PillarFeatureNet(dtype=)`` at inference (running
        statistics): (..., P, N, D) decorated features, (..., P, N) mask ->
        (..., P, C) in ``dtype``. Linear on ``dtype`` views, BatchNorm in
        f32 cast to ``dtype`` (flax's ``MaskedBatchNorm``), ReLU, masked max
        over N; empty pillars give 0."""
        bn = self.bn
        with precision(dtype):
            x = features.to(dtype) @ self.kernel.to(dtype)
        y = (x - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS)
        y = torch.relu((y * bn.weight + bn.bias).to(dtype))
        y = torch.where(mask[..., None], y, -1e9)
        return torch.where(mask.any(dim=-1)[..., None], y.amax(dim=-2), 0.0)

    @torch.no_grad()
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
            lin.weight = nn.Parameter(
                torch.zeros(feat_ch, anchors_per_loc * width))
            lin.bias = nn.Parameter(torch.zeros(anchors_per_loc * width))
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

    def forward(self, feat, dtype=torch.float32):
        """feat (B, Hf, Wf, C) -> (own, box_p, dir_p), f32. The feature map,
        weights and biases are cast to ``dtype`` and the products rounded
        there, as ``_wire_head(dtype=)`` does."""
        B, hf, wf, c = feat.shape
        hw = hf * wf
        a = hw * self.a_loc
        f = feat.reshape(B, hw, c).to(dtype)
        own = (f @ self.cls.weight[:, self.own_ch].to(dtype)
               + self.cls.bias[self.own_ch].to(dtype))
        ft = f.transpose(1, 2)                                 # (B, C, HW)
        box_p = (self.box.weight[:, self.perm_box].t().to(dtype) @ ft
                 + self.box.bias[self.perm_box][:, None].to(dtype))
        dir_p = (self.dir.weight[:, self.perm_dir].t().to(dtype) @ ft
                 + self.dir.bias[self.perm_dir][:, None].to(dtype))
        return (own.reshape(B, a).float(), box_p.reshape(B, 7, a).float(),
                dir_p.reshape(B, 2, a).float())

    def feature_major(self, feat, dtype=torch.float32):
        """The training head: feat (B, Hf, Wf, C) -> (cls (B, K, A),
        box (B, 7, A), dir (B, 2, A)) f32 in CANONICAL anchor order (a = hw
        * A_loc + a_loc). Each output feature k is its own (HW, C) @ (C,
        A_loc) product of the kernel's columns a_loc * k_dim + k, in
        ``dtype``, as ``tpu_pillars/models/head.py`` feature_major_head
        computes it."""
        B, hf, wf, c = feat.shape
        f = feat.reshape(B, hf * wf, c).to(dtype)

        def emit(lin, k_dim):
            outs = []
            for k in range(k_dim):
                cols = torch.arange(self.a_loc, device=feat.device) * k_dim + k
                out_k = (f @ lin.weight[:, cols].to(dtype)
                         + lin.bias[cols].to(dtype))
                outs.append(out_k.reshape(B, -1))
            return torch.stack(outs, dim=1).float()

        return emit(self.cls, self.k), emit(self.box, 7), emit(self.dir, 2)


class PointPillars(nn.Module):
    """Weights of the detector; load with ``weights.params_from_flax``, save
    with ``weights.flax_from_params``. The training forward is
    ``train.step``'s: it runs the PFN through ``ops.fused_pfn``,
    :meth:`RPNBackbone.train_forward` and :meth:`WireHead.feature_major`."""

    def __init__(self, config: PillarsConfig):
        super().__init__()
        self.config = config
        self.pfn = PFNWeights(config.num_decorated_features,
                              config.pfn_channels)
        self.rpn = RPNBackbone(config.pfn_channels, config.rpn_channels,
                               config.rpn_layers, config.rpn_up_channels)
        self.head = WireHead(3 * config.rpn_up_channels, config.num_classes,
                             config.anchors_per_loc)

    def features_from_canvas(self, canvas, dtype=torch.float32):
        """(B, H, W, C_in) canvas -> (B, H/2, W/2, C_feat) feature map in
        ``dtype``."""
        x = canvas.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with precision(dtype):
            return self.rpn(x, dtype).permute(0, 2, 3, 1).contiguous()

    def train_features_from_canvas(self, canvas, remat: bool = False,
                                   dtype=torch.float32):
        """Batch-statistics RPN: canvas -> (feature map (B, H/2, W/2,
        C_feat) in ``dtype``, one f32 (mean, var) per
        ``self.rpn.batch_norms()``). The caller holds ``full_fp32`` across
        forward and backward."""
        x = canvas.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feat, moments = self.rpn.train_forward(x, remat=remat, dtype=dtype)
        return feat.permute(0, 2, 3, 1), moments

    def wire_head(self, feat, dtype=torch.float32):
        with precision(dtype):
            return self.head(feat, dtype)
