"""K3 BEV scatter: pillar features -> dense (B, H, W, C) canvas.

Port of ``tpu_pillars/ops/bev_pallas.py`` (``scatter_to_bev_ring``, same
contract): each valid pillar's C features land at canvas cell ``pid``;
every other cell is zero. Pillar ids are unique per sample (the emit table
holds each pillar once), so the result is exact with no atomics. On a CUDA
tensor :func:`scatter_to_bev` launches ``csrc/bev_scatter.cu``; on a CPU
tensor it runs :func:`scatter_to_bev_plain`.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig


def _check(feats, pid, mask):
    if feats.dim() != 3 or pid.shape != feats.shape[:2] \
            or mask.shape != feats.shape[:2]:
        raise ValueError(f"scatter_to_bev wants feats (B, P, C), pid and "
                         f"mask (B, P); got {tuple(feats.shape)}, "
                         f"{tuple(pid.shape)}, {tuple(mask.shape)}")
    if feats.dtype != torch.float32 or pid.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        raise TypeError(f"scatter_to_bev wants float32 / int32 / bool, got "
                        f"{feats.dtype} / {pid.dtype} / {mask.dtype}")
    if not (feats.device == pid.device == mask.device):
        raise ValueError("scatter_to_bev inputs lie on different devices")


def scatter_to_bev(pillar_features, pid_per, pillar_mask,
                   config: PillarsConfig):
    """(B, P, C) f32 pillar features, (B, P) int32 pillar ids, (B, P) bool
    validity -> (B, H, W, C) f32 canvas."""
    _check(pillar_features, pid_per, pillar_mask)
    if pillar_features.device.type != "cuda":
        return scatter_to_bev_plain(pillar_features, pid_per, pillar_mask,
                                    config)
    H, W = config.grid_h, config.grid_w
    B, P, C = pillar_features.shape
    feats = pillar_features.contiguous()
    pid = pid_per.contiguous()
    mask = pillar_mask.contiguous()
    canvas = torch.zeros((B, H, W, C), dtype=torch.float32,
                         device=feats.device)
    fn = _build.function("bev_scatter", "bev_scatter", "ppppiiii")
    err = fn(feats.data_ptr(), pid.data_ptr(), mask.data_ptr(),
             canvas.data_ptr(), B, P, C, H * W, _build.stream_ptr(feats))
    _build.check(err, "scatter_to_bev")
    _build.LAUNCHES["bev_scatter"] += 1
    return canvas


def scatter_to_bev_plain(pillar_features, pid_per, pillar_mask,
                         config: PillarsConfig):
    """Plain PyTorch version of :func:`scatter_to_bev`: one masked index
    assignment into the flat canvas."""
    _check(pillar_features, pid_per, pillar_mask)
    H, W = config.grid_h, config.grid_w
    B, P, C = pillar_features.shape
    dev = pillar_features.device
    flat = (pid_per.long()
            + torch.arange(B, device=dev)[:, None] * (H * W))
    canvas = torch.zeros((B * H * W, C), dtype=torch.float32, device=dev)
    canvas[flat[pillar_mask]] = pillar_features[pillar_mask]
    return canvas.reshape(B, H, W, C)
