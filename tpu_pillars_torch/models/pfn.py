"""PillarFeatureNet: per-point linear layer -> masked BatchNorm -> ReLU ->
masked max over the points of each pillar. Port of
``tpu_pillars/models/pfn.py``.

The module holds the flax module's parameters (``kernel`` (D, C), the
BatchNorm's scale ``weight`` and ``bias``) and its running statistics.
Serving runs them folded (:meth:`PillarFeatureNet.folded`, for the K2 and
K6 kernels) or as the flax module computes them at inference
(:meth:`PillarFeatureNet.forward`). Training runs
:meth:`PillarFeatureNet.train_forward`: BatchNorm statistics over the
valid point slots only, returned to the caller, which updates the running
statistics once per (micro)batch, outside any checkpointed block (its
forward runs twice under remat).

``dtype`` has flax's cast points: the linear layer runs on ``dtype``
views of the f32 kernel, BatchNorm takes its moments and normalises in
f32 and returns ``dtype``; the ReLU and the max run in ``dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_pillars_torch.models.backbone import BN_EPS, BatchNorm, precision
from tpu_pillars_torch.ops.fused_pfn import fold_bn


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the last (channel) axis whose batch statistics count
    only the rows a mask marks (flax ``MaskedBatchNorm``: momentum 0.99,
    eps 1e-3, biased variance)."""

    def forward(self, x):
        """Running statistics, flax's order: ((x - mean) * rsqrt(var +
        eps)) * scale + bias, in f32 for a bf16 x."""
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + BN_EPS)
        return y * self.weight + self.bias

    def train_forward(self, x, mask, mesh=None):
        """x (..., C), mask (...) bool -> (y in x's dtype, mean (C,) f32,
        var (C,) f32). In f32: count = max(sum(mask), 1), mean = sum(x *
        mask) / count, var = sum((x - mean)^2 * mask) / count (two passes);
        y = ((x - mean) * rsqrt(var + eps)) * scale + bias, cast to x's
        dtype. With a ``mesh`` (sync-BN, as the flax module's
        ``axis_name``) the count and the mean's numerator are summed over
        its ranks, then the variance's numerator about that global mean.
        The running statistics are left to :meth:`update_running`."""
        dims = tuple(range(x.dim() - 1))
        fmask = mask[..., None].to(torch.float32)
        xf = x.float()
        count = fmask.sum()
        mean_num = (xf * fmask).sum(dim=dims)
        if mesh is not None:
            summed = mesh.psum(torch.cat([count[None], mean_num]))
            count, mean_num = summed[0], summed[1:]
        count = torch.clamp(count, min=1.0)
        mean = mean_num / count
        var_num = ((xf - mean) ** 2 * fmask).sum(dim=dims)
        if mesh is not None:
            var_num = mesh.psum(var_num)
        var = var_num / count
        y = (xf - mean) * torch.rsqrt(var + BN_EPS)
        return (y * self.weight + self.bias).to(x.dtype), mean, var


def _masked_max(y, mask):
    """(..., P, N, C) activations, (..., P, N) mask -> (..., P, C): the max
    over the valid slots (-1e9 fill; ``amax`` splits the gradient evenly
    among equal maxima, as JAX's max does), 0 for an empty pillar."""
    y = torch.where(mask[..., None], y, -1e9)
    return torch.where(mask.any(dim=-1)[..., None], y.amax(dim=-2), 0.0)


class PillarFeatureNet(nn.Module):
    """(..., P, N, D) decorated features, (..., P, N) mask -> (..., P, C)
    pillar features."""

    def __init__(self, in_dim: int, channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, channels))
        self.bn = MaskedBatchNorm(channels)

    def forward(self, features, mask, dtype=torch.float32):
        """The flax ``PillarFeatureNet(dtype=)`` at inference (running
        statistics): (..., P, N, D) decorated features, (..., P, N) mask ->
        (..., P, C) in ``dtype``. Linear on ``dtype`` views, BatchNorm in
        f32 cast to ``dtype`` (flax's ``MaskedBatchNorm``), ReLU, masked max
        over N; empty pillars give 0."""
        with precision(dtype):
            x = features.to(dtype) @ self.kernel.to(dtype)
        return _masked_max(torch.relu(self.bn(x).to(dtype)), mask)

    def train_forward(self, features, mask, dtype=torch.float32,
                      mesh=None):
        """The flax module in training (batch statistics): -> (features
        (..., P, C) in ``dtype``, mean, var), the moments f32 over the
        valid slots of the whole batch (of every rank of ``mesh``). The
        caller holds ``backbone.full_fp32`` across forward and backward."""
        x = features.to(dtype) @ self.kernel.to(dtype)
        y, mean, var = self.bn.train_forward(x, mask, mesh)
        return _masked_max(torch.relu(y), mask), mean, var

    @torch.no_grad()
    def folded(self):
        bn = self.bn
        return fold_bn(self.kernel, bn.weight, bn.bias, bn.running_mean,
                       bn.running_var)
