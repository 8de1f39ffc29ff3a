"""Box3D — the public detection type, plus corner math.

THE public API of the reference is ``sample -> List[Box3D]`` with
class/score/yaw (SURVEY.md section 1, L5 / BASELINE.json north-star). Box3D is
a plain host-side dataclass; device code works on packed (N, 7) float arrays
``[x, y, z, w, l, h, yaw]`` and converts at the boundary.

Conventions (Lyft/nuScenes devkit compatible):
  * center = box centroid (x, y, z)
  * wlh    = (width, length, height); length is along the heading (+x local)
  * yaw    = rotation about +z of the heading axis
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tpu_pillars_torch.geometry.quaternion import (
    quat_from_yaw,
    quat_multiply,
    quat_rotate,
    yaw_from_quat,
)


@dataclasses.dataclass
class Box3D:
    center: np.ndarray            # (3,)
    wlh: np.ndarray               # (3,) width, length, height
    yaw: float                    # heading about +z (radians)
    label: str = ""               # class name
    score: float = -1.0           # detection confidence; -1 for ground truth
    token: str = ""               # sample token this box belongs to
    velocity: Optional[np.ndarray] = None   # (2,) vx, vy (m/s), if known

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64).reshape(3)
        self.wlh = np.asarray(self.wlh, dtype=np.float64).reshape(3)
        self.yaw = float(self.yaw)
        if self.velocity is not None:
            self.velocity = np.asarray(self.velocity,
                                       dtype=np.float64).reshape(2)

    # --- packed representation used on-device ---

    def to_array(self) -> np.ndarray:
        """(7,) = [x, y, z, w, l, h, yaw]."""
        return np.concatenate([self.center, self.wlh, [self.yaw]])

    @staticmethod
    def from_array(arr, label: str = "", score: float = -1.0, token: str = "") -> "Box3D":
        arr = np.asarray(arr, dtype=np.float64)
        return Box3D(center=arr[:3], wlh=arr[3:6], yaw=float(arr[6]),
                     label=label, score=score, token=token)

    # --- frame transforms (used lidar -> ego -> global, SURVEY.md 3.1) ---

    def transformed(self, rotation_q, translation) -> "Box3D":
        """Apply a rigid transform given as (quaternion, translation)."""
        new_center = quat_rotate(rotation_q, self.center) + np.asarray(translation)
        q_box = quat_from_yaw(self.yaw)
        new_yaw = float(yaw_from_quat(quat_multiply(rotation_q, q_box)))
        velocity = None
        if self.velocity is not None:
            velocity = quat_rotate(rotation_q,
                                   np.append(self.velocity, 0.0))[:2]
        return Box3D(new_center, self.wlh.copy(), new_yaw,
                     label=self.label, score=self.score, token=self.token,
                     velocity=velocity)

    def corners_bev(self) -> np.ndarray:
        return box_corners_bev(self.to_array()[None])[0]

    def corners_3d(self) -> np.ndarray:
        return box_corners_3d(self.to_array()[None])[0]

    def __repr__(self):
        return (f"Box3D({self.label or '?'} s={self.score:.3f} "
                f"c=({self.center[0]:.2f},{self.center[1]:.2f},{self.center[2]:.2f}) "
                f"wlh=({self.wlh[0]:.2f},{self.wlh[1]:.2f},{self.wlh[2]:.2f}) "
                f"yaw={self.yaw:.3f})")


def box_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """BEV footprint corners of packed boxes.

    boxes: (N, >=7) [x, y, z, w, l, h, yaw] -> (N, 4, 2) corners CCW starting
    front-left (local (+l/2, +w/2)).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    x, y = boxes[:, 0], boxes[:, 1]
    w, l, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    # local corners, CCW: (+l/2,+w/2), (-l/2,+w/2), (-l/2,-w/2), (+l/2,-w/2)
    lx = np.stack([l / 2, -l / 2, -l / 2, l / 2], axis=-1)   # (N, 4)
    ly = np.stack([w / 2, w / 2, -w / 2, -w / 2], axis=-1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    gx = x[:, None] + c * lx - s * ly
    gy = y[:, None] + s * lx + c * ly
    return np.stack([gx, gy], axis=-1)


def box_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, >=7) -> (N, 8, 3); bottom 4 corners then top 4, same BEV order."""
    boxes = np.asarray(boxes, dtype=np.float64)
    bev = box_corners_bev(boxes)                       # (N, 4, 2)
    z, h = boxes[:, 2], boxes[:, 5]
    z_lo = (z - h / 2)[:, None]
    z_hi = (z + h / 2)[:, None]
    bottom = np.concatenate([bev, np.broadcast_to(z_lo[:, :, None], bev.shape[:2] + (1,))], -1)
    top = np.concatenate([bev, np.broadcast_to(z_hi[:, :, None], bev.shape[:2] + (1,))], -1)
    return np.concatenate([bottom, top], axis=1)
