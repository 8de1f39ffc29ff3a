"""``train``: synthetic scenes with ground-truth boxes (the port's
``data.synthetic`` scenes, copied: object surfaces and ground clutter),
padded into batches. Parameters: ``pool`` batches of ``batch`` scenes,
each of ``objects`` boxes with ``points_per_object`` points on their
faces and ``clutter`` ground points, ``max_gt`` GT slots a sample."""

from __future__ import annotations

import numpy as np


def _box_surface(rng, box, n):
    x, y, z, w, l, h, yaw = box
    face = rng.integers(0, 5, n)
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    lx = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u)) * l
    ly = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u)) * w
    lx = np.where((face == 2) | (face == 3), v * l, lx)
    lz = np.where(face == 4, 0.5, rng.uniform(-0.5, 0.5, n)) * h
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([x + c * lx - s * ly, y + s * lx + c * ly, z + lz], axis=1)


def train_scene(rng, cfg: dict, objects: int, points_per_object: int,
                clutter: int, span_frac: float = 0.8):
    """One synthetic scene -> (points (n, 4), gt_boxes (G, 7), gt_classes
    (G,)). Boxes of every class with points on their faces, overlaps
    rejected, plus uniform ground clutter over the whole range."""
    classes = cfg["classes"]
    span_x = (cfg["x_max"] - cfg["x_min"]) * span_frac / 2
    span_y = (cfg["y_max"] - cfg["y_min"]) * span_frac / 2
    boxes = np.zeros((objects, 7), np.float32)
    labels = np.zeros((objects,), np.int32)
    pts = []
    placed = attempts = 0
    while placed < objects and attempts < objects * 20:
        attempts += 1
        ci = int(rng.choice(len(classes)))
        spec = classes[ci]
        scale = rng.uniform(0.85, 1.15)
        b = np.array([rng.uniform(-span_x, span_x),
                      rng.uniform(-span_y, span_y),
                      spec["z_center"] + rng.uniform(-0.2, 0.2),
                      spec["width"] * scale, spec["length"] * scale,
                      spec["height"] * scale, rng.uniform(-np.pi, np.pi)],
                     np.float32)
        if placed:
            d = np.hypot(boxes[:placed, 0] - b[0], boxes[:placed, 1] - b[1])
            sep = (np.maximum(boxes[:placed, 4], boxes[:placed, 3])
                   + max(b[3], b[4])) * 0.75
            if (d < sep).any():
                continue
        boxes[placed] = b
        labels[placed] = ci
        pts.append(_box_surface(rng, b, points_per_object))
        placed += 1
    gx = rng.uniform(cfg["x_min"], cfg["x_max"], clutter)
    gy = rng.uniform(cfg["y_min"], cfg["y_max"], clutter)
    gz = rng.normal(-2.0, 0.05, clutter)
    pts.append(np.stack([gx, gy, gz], axis=1))
    xyz = np.concatenate(pts)
    points = np.concatenate([xyz, rng.uniform(0, 1, len(xyz))[:, None]],
                            axis=1).astype(np.float32)
    return points[rng.permutation(len(points))], boxes[:placed], \
        labels[:placed]


def train_batch(scenes, cfg: dict, max_gt: int):
    """Scenes -> (points (B, M, F) padded with 1e6, num_points (B,),
    gt_boxes (B, G, 7), gt_classes (B, G), gt_valid (B, G)), numpy."""
    B, M = len(scenes), cfg["max_points"]
    pts = np.full((B, M, 4), 1e6, np.float32)
    npts = np.zeros((B,), np.int32)
    gb = np.zeros((B, max_gt, 7), np.float32)
    gc = np.zeros((B, max_gt), np.int32)
    gv = np.zeros((B, max_gt), bool)
    for i, (p, boxes, labels) in enumerate(scenes):
        n = min(len(p), M)
        pts[i, :n] = p[:n]
        npts[i] = n
        g = min(len(boxes), max_gt)
        gb[i, :g], gc[i, :g], gv[i, :g] = boxes[:g], labels[:g], True
    return pts, npts, gb, gc, gv


def make(traffic: dict, cfg: dict, rng) -> list:
    out = []
    for _ in range(traffic["pool"]):
        scenes = [train_scene(rng, cfg, traffic["objects"],
                              traffic["points_per_object"],
                              traffic["clutter"])
                  for _ in range(traffic["batch"])]
        out.append(train_batch(scenes, cfg, traffic["max_gt"]))
    return out
