"""Seeded CenterPoint weights and multi-sweep clouds for the tests of the
port's CenterPoint kind (CPU and card)."""

import numpy as np
import torch

from tpu_pillars_torch.models.centerpoint import CenterPoint


def center_state_dict(cfg, seed: int = 0) -> dict:
    """A state dict of ``CenterPoint(cfg)`` drawn from ``seed``: kernels
    lecun-normal, BatchNorms with drawn scales, biases and running
    statistics (no BatchNorm is the identity), conv biases small, the
    heatmaps' bias -2.19."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in CenterPoint(cfg).state_dict().items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=gen) + 0.5
        elif k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif v.dim() == 1 and k.endswith(".weight"):
            sd[k] = 0.8 + 0.4 * torch.rand(v.shape, generator=gen)
        elif v.dim() == 1:
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        else:
            fan = v.shape[0] if k.startswith("pfn.") else v[0].numel()
            sd[k] = torch.randn(v.shape, generator=gen) / fan ** 0.5
    for t in range(cfg.num_tasks):
        sd[f"head.tasks.{t}.hm.b2"].fill_(-2.19)
    return sd


def center_cloud(rng, cfg, n: int, margin: float = 1.0) -> np.ndarray:
    """(n, 5) f32 points over the grid (and ``margin`` m past it), z over
    the range and a little past it, intensity U(0, 1), dt on the 0.05 s
    sweep grid."""
    p = np.zeros((n, 5), np.float32)
    p[:, 0] = rng.uniform(cfg.x_min - margin, cfg.x_max + margin, n)
    p[:, 1] = rng.uniform(cfg.y_min - margin, cfg.y_max + margin, n)
    p[:, 2] = rng.uniform(cfg.z_min - 0.5, cfg.z_max + 0.5, n)
    p[:, 3] = rng.uniform(0.0, 1.0, n)
    p[:, 4] = rng.integers(0, cfg.num_sweeps, n) * 0.05
    return p
