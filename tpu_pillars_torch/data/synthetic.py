"""Seeded synthetic lidar scenes, numpy only — the port's own copy of
``tpu_pillars/data/synthetic.py`` (same draws from the same generator, so
one seed gives both packages the same scenes).

A scene = ground-plane clutter + boxes of configured classes with points
sampled on their faces (lidar hits surfaces, not volumes).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.geometry.boxes import Box3D


@dataclasses.dataclass
class SyntheticScene:
    points: np.ndarray        # (n, 4) x, y, z, intensity
    gt_boxes: np.ndarray      # (G, 7)
    gt_classes: np.ndarray    # (G,) int32
    boxes: List[Box3D]


def _sample_box_surface(rng, box, n):
    """Sample n lidar-like hits on the faces of a packed box
    [x, y, z, w, l, h, yaw]."""
    x, y, z, w, l, h, yaw = box
    # pick faces: +-x (front/back), +-y (sides), +z (roof)
    face = rng.integers(0, 5, n)
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    lx = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u)) * l
    ly = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u)) * w
    # for side faces u was consumed by the fixed axis; reuse v for the other
    lx = np.where((face == 2) | (face == 3), v * l, lx)
    lz = np.where(face == 4, 0.5, rng.uniform(-0.5, 0.5, n)) * h
    c, s = np.cos(yaw), np.sin(yaw)
    gx = x + c * lx - s * ly
    gy = y + s * lx + c * ly
    gz = z + lz
    return np.stack([gx, gy, gz], axis=1)


def make_scene(rng: np.random.Generator, config: PillarsConfig,
               num_objects: int = 12, points_per_object: int = 120,
               clutter: int = 2000, span_frac: float = 0.8,
               class_subset=None) -> SyntheticScene:
    classes = (list(range(config.num_classes)) if class_subset is None
               else list(class_subset))
    span_x = (config.x_max - config.x_min) * span_frac / 2
    span_y = (config.y_max - config.y_min) * span_frac / 2

    gt_boxes = np.zeros((num_objects, 7), dtype=np.float32)
    gt_classes = np.zeros((num_objects,), dtype=np.int32)
    pts = []
    placed = 0
    attempts = 0
    while placed < num_objects and attempts < num_objects * 20:
        attempts += 1
        ci = int(rng.choice(classes))
        spec = config.classes[ci]
        scale = rng.uniform(0.85, 1.15)
        b = np.array([
            rng.uniform(-span_x, span_x),
            rng.uniform(-span_y, span_y),
            spec.z_center + rng.uniform(-0.2, 0.2),
            spec.width * scale,
            spec.length * scale,
            spec.height * scale,
            rng.uniform(-np.pi, np.pi),
        ], dtype=np.float32)
        # reject overlaps (keeps GT boxes NMS-separable)
        if placed:
            d = np.hypot(gt_boxes[:placed, 0] - b[0],
                         gt_boxes[:placed, 1] - b[1])
            min_sep = (np.maximum(gt_boxes[:placed, 4], gt_boxes[:placed, 3])
                       + max(b[3], b[4])) * 0.75
            if (d < min_sep).any():
                continue
        gt_boxes[placed] = b
        gt_classes[placed] = ci
        pts.append(_sample_box_surface(rng, b, points_per_object))
        placed += 1
    gt_boxes = gt_boxes[:placed]
    gt_classes = gt_classes[:placed]

    # ground plane + uniform clutter
    gx = rng.uniform(config.x_min, config.x_max, clutter)
    gy = rng.uniform(config.y_min, config.y_max, clutter)
    gz = rng.normal(-2.0, 0.05, clutter)
    pts.append(np.stack([gx, gy, gz], axis=1))

    xyz = np.concatenate(pts, axis=0)
    intensity = rng.uniform(0, 1, len(xyz))[:, None]
    cols = [xyz, intensity]
    if config.num_sweeps > 1:
        # sweep-lag dt channel: each point tagged with one of num_sweeps
        # discrete lags, keyframe (dt=0) most populated
        lags = np.arange(config.num_sweeps, dtype=np.float32) * 0.1
        w = 1.0 / (1.0 + np.arange(config.num_sweeps))
        cols.append(rng.choice(lags, len(xyz), p=w / w.sum())[:, None])
    points = np.concatenate(cols, axis=1).astype(np.float32)
    rng.shuffle(points, axis=0)

    names = config.class_names
    boxes = [Box3D.from_array(b, label=names[c])
             for b, c in zip(gt_boxes, gt_classes)]
    return SyntheticScene(points, gt_boxes, gt_classes, boxes)


def scenes_to_train_batch(scenes, config: PillarsConfig, max_gt_boxes: int):
    """Pad a list of scenes into a static-shape TrainBatch-compatible tuple
    (points, num_points, gt_boxes, gt_classes, gt_valid), all NumPy."""
    B = len(scenes)
    pts = np.full((B, config.max_points, config.num_input_features), 1e6,
                  np.float32)
    npts = np.zeros((B,), np.int32)
    gb = np.zeros((B, max_gt_boxes, 7), np.float32)
    gc = np.zeros((B, max_gt_boxes), np.int32)
    gv = np.zeros((B, max_gt_boxes), bool)
    for i, scene in enumerate(scenes):
        n = min(len(scene.points), config.max_points)
        pts[i, :n] = scene.points[:n, : config.num_input_features]
        npts[i] = n
        g = min(len(scene.gt_boxes), max_gt_boxes)
        gb[i, :g] = scene.gt_boxes[:g]
        gc[i, :g] = scene.gt_classes[:g]
        gv[i, :g] = True
    return pts, npts, gb, gc, gv
