"""Dense BEV anchor grid (SURVEY.md section 2 'Anchor generator').

One canonical (w, l, h, z) anchor per class at two yaws (0, pi/2), placed at
every feature-map location (BEV stride `head_stride`). Layout is pinned to the
detection head's output reshape: flatten order (row, col, class*yaw), i.e.
``a_loc = class_idx * num_yaws + yaw_idx``.

Anchors are compile-time constants of the jitted program — generated once in
NumPy and closed over, never recomputed per frame.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from tpu_pillars_torch.config import PillarsConfig


@lru_cache(maxsize=8)
def _make_anchors_cached(config: PillarsConfig):
    H, W = config.feature_h, config.feature_w
    stride_x = config.voxel_x * config.head_stride
    stride_y = config.voxel_y * config.head_stride

    xs = config.x_min + (np.arange(W) + 0.5) * stride_x          # (W,)
    ys = config.y_min + (np.arange(H) + 0.5) * stride_y          # (H,)

    num_yaws = len(config.anchor_yaws)
    A_loc = config.anchors_per_loc

    # per-location anchor templates: (A_loc, 5) = [w, l, h, z, yaw]
    templates = np.zeros((A_loc, 5), dtype=np.float32)
    class_ids = np.zeros((A_loc,), dtype=np.int32)
    for ci, spec in enumerate(config.classes):
        for yi, yaw in enumerate(config.anchor_yaws):
            a = ci * num_yaws + yi
            templates[a] = [spec.width, spec.length, spec.height, spec.z_center, yaw]
            class_ids[a] = ci

    grid_x = np.broadcast_to(xs[None, :, None], (H, W, A_loc))
    grid_y = np.broadcast_to(ys[:, None, None], (H, W, A_loc))
    tpl = np.broadcast_to(templates[None, None], (H, W, A_loc, 5))

    anchors = np.stack(
        [grid_x, grid_y, tpl[..., 3], tpl[..., 0], tpl[..., 1], tpl[..., 2], tpl[..., 4]],
        axis=-1,
    )  # (H, W, A_loc, 7) = [x, y, z, w, l, h, yaw]
    anchors = anchors.reshape(-1, 7).astype(np.float32)
    anchor_class = np.broadcast_to(class_ids[None, None], (H, W, A_loc)).reshape(-1).copy()
    anchors.setflags(write=False)
    anchor_class.setflags(write=False)
    return anchors, anchor_class


def make_anchors(config: PillarsConfig):
    """Returns (anchors (A, 7) float32, anchor_class_ids (A,) int32)."""
    return _make_anchors_cached(config)
