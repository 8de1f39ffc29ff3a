"""Training-time data augmentation, numpy — copy of
``tpu_pillars/data/augment.py``: the four GLOBAL transforms (random flip,
global rotation, global scaling, global translation, applied consistently
to the cloud and the GT boxes) plus SECOND-lineage PER-OBJECT noise
(independent yaw jitter + xy translation of each GT box and the points
inside it, collision-rejected). Host-side NumPy on raw scenes, before
padding and pillarization; the same ``default_rng`` draws give the JAX
package's bits. GT-database sampling lives in ``data/gt_sampler.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip_y_prob: float = 0.5          # mirror across the x axis (y -> -y)
    rotation_range: float = np.pi / 4  # global yaw in [-r, r]
    scale_range: Tuple[float, float] = (0.95, 1.05)
    translate_std: float = 0.2         # metres, per axis (x, y, z)


def augment_scene(rng: np.random.Generator, points: np.ndarray,
                  gt_boxes: np.ndarray, cfg: AugmentConfig = AugmentConfig()):
    """points (N, >=3), gt_boxes (G, 7) -> augmented copies.

    Feature columns beyond xyz (intensity, dt) pass through untouched.
    """
    points = np.array(points, dtype=np.float32, copy=True)
    gt_boxes = np.array(gt_boxes, dtype=np.float32, copy=True)

    # global flip across x axis: y -> -y, yaw -> -yaw
    if rng.uniform() < cfg.flip_y_prob:
        points[:, 1] = -points[:, 1]
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]

    # global rotation about +z
    theta = rng.uniform(-cfg.rotation_range, cfg.rotation_range)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]], dtype=np.float32)
    points[:, :2] = points[:, :2] @ rot.T
    gt_boxes[:, :2] = gt_boxes[:, :2] @ rot.T
    gt_boxes[:, 6] += theta

    # global scale
    scale = rng.uniform(*cfg.scale_range)
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale

    # global translation
    t = rng.normal(0.0, cfg.translate_std, 3).astype(np.float32)
    points[:, :3] += t
    gt_boxes[:, :3] += t

    # keep yaw in [-pi, pi)
    gt_boxes[:, 6] = (gt_boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
    return points, gt_boxes


@dataclasses.dataclass(frozen=True)
class ObjectNoiseConfig:
    rotation_range: float = np.pi / 9   # per-box yaw jitter in [-r, r]
    translate_std: float = 0.25         # per-box xy translation (metres)
    max_attempts: int = 10              # collision-rejection retries
    prob: float = 1.0                   # per-box chance of being jittered


def noise_per_object(rng: np.random.Generator, points: np.ndarray,
                     gt_boxes: np.ndarray,
                     cfg: ObjectNoiseConfig = ObjectNoiseConfig()):
    """SECOND-lineage per-object augmentation: each GT box — and the points
    inside it — gets an independent yaw rotation about the box center and
    an xy translation. A draw is rejected (retried up to max_attempts, then
    the box is left untouched) if the moved footprint would overlap any
    other box in its CURRENT position, so augmented scenes stay physically
    consistent. Points claimed by an earlier box never move twice; feature
    columns beyond xyz pass through untouched.

    Composes with :func:`augment_scene` (apply this first: per-object noise
    in the original frame, then the global transforms)."""
    from tpu_pillars_torch.data.gt_sampler import points_in_boxes
    from tpu_pillars_torch.reference_cpu.postprocess import (
        rotated_iou_bev_np,
    )

    points = np.array(points, dtype=np.float32, copy=True)
    gt_boxes = np.array(gt_boxes, dtype=np.float32, copy=True)
    G = len(gt_boxes)
    claimed = np.zeros(len(points), bool)
    # Membership of EVERY box on the initial cloud in one vectorized pass.
    # Identical to the old per-g points_in_box(current_points, box) &
    # ~claimed: points that moved before g's turn are exactly the claimed
    # ones (masked out), and unclaimed points haven't moved. With the
    # circumradius pre-filter below, the exact polygon clips run only on
    # pairs that can overlap.
    member_all = (points_in_boxes(points, gt_boxes) if G
                  else np.zeros((0, len(points)), bool))
    radii = 0.5 * np.hypot(gt_boxes[:, 3], gt_boxes[:, 4])  # w,l never move
    for g in range(G):
        member = member_all[g] & ~claimed
        claimed |= member
        if rng.uniform() >= cfg.prob:
            continue
        others = np.delete(gt_boxes, g, axis=0)
        others_rad = np.delete(radii, g)
        for _ in range(cfg.max_attempts):
            dtheta = rng.uniform(-cfg.rotation_range, cfg.rotation_range)
            dt = rng.normal(0.0, cfg.translate_std, 2).astype(np.float32)
            cand = gt_boxes[g].copy()
            cand[:2] += dt
            cand[6] = (cand[6] + dtheta + np.pi) % (2 * np.pi) - np.pi
            if G > 1:
                # zero BEV overlap is guaranteed beyond summed circumradii;
                # exact rotated IoU only on near pairs (decisions, and so
                # the augmentation stream, stay bit-identical)
                r = radii[g] + others_rad + 1e-3
                dx = others[:, 0] - cand[0]
                dy = others[:, 1] - cand[1]
                near = dx * dx + dy * dy < r * r
                if near.any() and (rotated_iou_bev_np(
                        cand[None], others[near]) > 0.0).any():
                    continue
            # move the member points with the box: rotate about the OLD
            # center by dtheta, then translate
            c, s = np.cos(dtheta), np.sin(dtheta)
            d = points[member, :2] - gt_boxes[g, :2]
            points[member, 0] = (gt_boxes[g, 0] + c * d[:, 0] - s * d[:, 1]
                                 + dt[0])
            points[member, 1] = (gt_boxes[g, 1] + s * d[:, 0] + c * d[:, 1]
                                 + dt[1])
            gt_boxes[g] = cand
            break
    return points, gt_boxes
