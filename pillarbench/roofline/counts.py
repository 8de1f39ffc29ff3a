"""Counts of a cloud that the kernels' bytes and the model's FLOPs turn
on: its valid points, the pillars kept under the budget and the points
kept in them."""

from __future__ import annotations

import numpy as np

from pillarbench.reference.detect import crop_and_budget


def cloud_counts(points: np.ndarray, cfg) -> tuple:
    """One cloud as the detector sees it (``cfg`` a ``RefConfig``) ->
    (valid points, kept pillars, kept points)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    col = np.floor((x - cfg.x_min) / cfg.voxel_x).astype(np.int64)
    row = np.floor((y - cfg.y_min) / cfg.voxel_y).astype(np.int64)
    ok = ((col >= 0) & (col < cfg.grid_w) & (row >= 0) & (row < cfg.grid_h)
          & (z >= cfg.z_min) & (z <= cfg.z_max))
    _, cnt = np.unique(row[ok] * cfg.grid_w + col[ok], return_counts=True)
    cnt = cnt[:cfg.max_pillars]
    return (int(ok.sum()), len(cnt),
            int(np.minimum(cnt, cfg.max_points_per_pillar).sum()))


def mean_counts(clouds, cfg, crop: bool = True) -> dict:
    """Mean {"valid", "pillars", "kept"} over clouds ((n, F) arrays; with
    ``crop`` the host crop and point budget are applied first)."""
    rows = [cloud_counts(crop_and_budget(c, cfg) if crop else c, cfg)
            for c in clouds]
    v, p, k = (float(np.mean(x)) for x in zip(*rows))
    return {"valid": v, "pillars": p, "kept": k}
