"""K6 PFN on decorated pillars: linear (BatchNorm folded) + bias + ReLU +
masked max over the points of each pillar.

Port of ``tpu_pillars/ops/pfn_pallas.py`` (``pfn_fused``), the classic
front end's PillarFeatureNet at inference. Fold the BatchNorm with
``ops.fused_pfn.fold_bn``. On a CUDA tensor :func:`pfn_fused` makes one
launch of ``csrc/pfn.cu`` into ``torch.empty`` (:func:`pfn_fused_cuda`) and
runs no other torch op; on a CPU tensor it runs :func:`pfn_fused_plain`. Both sum the D products in
order f = 0, 1, ..., then add the bias, and the kernel is built without
fused multiply-adds, so the two round the same f32 operations.

What bounds the kernel is bytes: the mask, the valid slots' rows and the
output, a tenth of the (P, N, D) input on lidar-like sweeps. A warp reads
the masks of a step of pillars first, loads only their valid rows, one per
lane, and issues the next step's mask loads before it computes, with the
weights in registers and no block-wide barrier. It takes the max over the
rows' sums and adds the bias and the ReLU after it, which gives the same
values because both are monotone; the design notes are in the ``.cu``
header.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build


def _check(features, mask, weight, bias):
    if features.dim() != 3 or mask.shape != features.shape[:2]:
        raise ValueError(f"pfn_fused wants features (P, N, D) and mask "
                         f"(P, N); got {tuple(features.shape)} and "
                         f"{tuple(mask.shape)}")
    D = features.shape[2]
    if weight.dim() != 2 or weight.shape[0] != D \
            or bias.shape != (weight.shape[1],):
        raise ValueError(f"pfn_fused wants weight (D={D}, C) and bias (C,); "
                         f"got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if mask.dtype != torch.bool or any(
            t.dtype != torch.float32 for t in (features, weight, bias)):
        raise TypeError(f"pfn_fused wants float32 features/weight/bias and a "
                        f"bool mask, got {features.dtype}, {weight.dtype}, "
                        f"{bias.dtype}, {mask.dtype}")
    if not (features.device == mask.device == weight.device == bias.device):
        raise ValueError("pfn_fused inputs lie on different devices")


def pfn_fused(features, mask, weight, bias):
    """features (P, N, D) f32, mask (P, N) bool, folded weight (D, C) and
    bias (C,) -> pillar features (P, C) f32; a pillar with no valid point
    gives 0. The op ``tpu_pillars::pfn_fused`` (``_build.kernel_op``):
    :func:`pfn_fused_cuda` on a CUDA tensor, :func:`pfn_fused_plain` on a
    CPU tensor."""
    _check(features, mask, weight, bias)
    return _PFN_FUSED(features, mask, weight, bias)


def pfn_fused_cuda(features: torch.Tensor, mask: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K6's launch, the CUDA implementation of ``tpu_pillars::pfn_fused``."""
    P, N, D = features.shape
    C = weight.shape[1]
    feats = features.contiguous()
    m = mask.contiguous()
    w, b = weight.contiguous(), bias.contiguous()
    out = torch.empty((P, C), dtype=torch.float32, device=feats.device)
    _build.launch("pfn", "pfn_fused", "pppppiiii", feats, m, w, b, out, P, N,
                  D, C)
    return out


def _pfn_fused_fake(features, mask, weight, bias):
    return features.new_empty((features.shape[0], weight.shape[1]))


def pfn_fused_plain(features, mask, weight, bias):
    """Plain PyTorch version of :func:`pfn_fused`: the JAX kernel's
    arithmetic (linear + bias, ReLU, -1e9 fill, max, 0 for empty pillars)
    with the D products summed in the kernel's order."""
    _check(features, mask, weight, bias)
    D = features.shape[2]
    u = features[..., 0:1] * weight[0]
    for f in range(1, D):
        u = u + features[..., f:f + 1] * weight[f]               # (P, N, C)
    u = torch.clamp(u + bias, min=0.0)
    u = torch.where(mask[..., None], u, -1e9)
    pooled = u.amax(dim=1)
    return torch.where(mask.any(dim=1)[:, None], pooled, 0.0)


_PFN_FUSED = _build.kernel_op("pfn_fused", pfn_fused_cuda, pfn_fused_plain,
                              _pfn_fused_fake)
