"""Numpy pillarizer of the CPU reference — copy of
``tpu_pillars/reference_cpu/pillarizer.py``: the reference's host-side
binning with the canonical semantics of the JAX ``ops/voxelize.py``:
pillars ordered by ascending id (first `max_pillars` kept), points keep
input order within a pillar (first `max_points_per_pillar` kept),
decoration = (raw, offsets-to-pillar-mean, offsets-to-cell-center), zero
padding. Every feature column of the points passes through, the dt column
of a multi-sweep config included.
"""

from __future__ import annotations

import numpy as np

from tpu_pillars_torch.config import PillarsConfig


def pillarize_np(points: np.ndarray, config: PillarsConfig):
    """points: (n, F) float32 (real points only, no padding).

    Returns (features (P, N, D) f32, mask (P, N) bool, coords (P, 2) i32,
    pillar_mask (P,) bool) — same contract as ops.voxelize.pillarize.
    """
    P, N = config.max_pillars, config.max_points_per_pillar
    W, H = config.grid_w, config.grid_h
    points = np.asarray(points, dtype=np.float32)
    F = points.shape[1]

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    col = np.floor((x - config.x_min) / config.voxel_x).astype(np.int64)
    row = np.floor((y - config.y_min) / config.voxel_y).astype(np.int64)
    valid = (
        (col >= 0) & (col < W) & (row >= 0) & (row < H)
        & (z >= config.z_min) & (z <= config.z_max)
    )
    pts = points[valid]
    pid = (row[valid] * W + col[valid]).astype(np.int64)

    order = np.argsort(pid, kind="stable")      # by id, input order preserved
    pid_s = pid[order]
    pts_s = pts[order]

    n_pts = len(pid_s)
    features = np.zeros((P, N, F + 5), dtype=np.float32)
    raw = np.zeros((P, N, F), dtype=np.float32)
    mask = np.zeros((P, N), dtype=bool)
    coords = np.zeros((P, 2), dtype=np.int32)
    pillar_mask = np.zeros((P,), dtype=bool)
    if n_pts == 0:
        return features, mask, coords, pillar_mask

    new_seg = np.concatenate([[True], pid_s[1:] != pid_s[:-1]])
    pillar_ord = np.cumsum(new_seg) - 1                       # ordinal by id
    idx = np.arange(n_pts)
    seg_start = np.maximum.accumulate(np.where(new_seg, idx, 0))
    rank = idx - seg_start

    keep = (rank < N) & (pillar_ord < P)
    po, rk = pillar_ord[keep], rank[keep]
    raw[po, rk] = pts_s[keep]
    mask[po, rk] = True

    first = new_seg & (pillar_ord < P)
    p_ids = pid_s[first]
    p_ord = pillar_ord[first]
    coords[p_ord, 0] = p_ids // W
    coords[p_ord, 1] = p_ids % W
    pillar_mask[p_ord] = True

    # decoration — identical formulas to ops.voxelize.decorate
    fmask = mask[..., None].astype(np.float32)
    count = np.maximum(fmask.sum(axis=1), 1.0)
    mean_xyz = (raw[..., :3] * fmask).sum(axis=1) / count
    off_mean = raw[..., :3] - mean_xyz[:, None, :]
    cx = config.x_min + (coords[:, 1].astype(np.float32) + 0.5) * config.voxel_x
    cy = config.y_min + (coords[:, 0].astype(np.float32) + 0.5) * config.voxel_y
    off_center = np.stack(
        [raw[..., 0] - cx[:, None], raw[..., 1] - cy[:, None]], axis=-1
    )
    features = np.concatenate([raw, off_mean, off_center], axis=-1) * fmask
    return features, mask, coords, pillar_mask
