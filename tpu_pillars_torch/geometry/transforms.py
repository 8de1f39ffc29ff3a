"""Rigid (SE3) frame transforms: sensor <-> ego <-> global.

Covers the reference's L0 transform duties (SURVEY.md section 2 'Lyft dataset
wrapper': "sensor<->ego<->global transforms via quaternions") without the
external lyft_dataset_sdk/pyquaternion dependencies.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_pillars_torch.geometry.quaternion import (
    quat_inverse,
    quat_multiply,
    quat_rotate,
    quat_to_rotation_matrix,
)


@dataclasses.dataclass(frozen=True)
class Pose:
    """A rigid transform: x_out = R(rotation) @ x_in + translation."""

    rotation: np.ndarray     # quaternion (4,) wxyz
    translation: np.ndarray  # (3,)

    @staticmethod
    def identity() -> "Pose":
        return Pose(np.array([1.0, 0, 0, 0]), np.zeros(3))

    @staticmethod
    def from_record(rec: dict) -> "Pose":
        """From a Lyft-format ego_pose / calibrated_sensor JSON record."""
        return Pose(np.asarray(rec["rotation"], dtype=np.float64),
                    np.asarray(rec["translation"], dtype=np.float64))


def compose(a: Pose, b: Pose) -> Pose:
    """Transform equal to applying b first, then a."""
    return Pose(
        rotation=quat_multiply(a.rotation, b.rotation),
        translation=quat_rotate(a.rotation, b.translation) + a.translation,
    )


def inverse(p: Pose) -> Pose:
    q_inv = quat_inverse(p.rotation)
    return Pose(rotation=q_inv, translation=-quat_rotate(q_inv, p.translation))


def transform_points(p: Pose, points: np.ndarray) -> np.ndarray:
    """Apply pose to points (N, >=3); extra feature columns pass through."""
    points = np.asarray(points)
    R = quat_to_rotation_matrix(p.rotation)
    xyz = points[:, :3] @ R.T + p.translation
    return np.concatenate([xyz.astype(points.dtype), points[:, 3:]], axis=1)


def lidar_to_global(calibrated_sensor: dict, ego_pose: dict) -> Pose:
    """Pose mapping lidar-frame coordinates to the global frame
    (SURVEY.md 3.1 last step: 'to Box3D ...; lidar->global')."""
    return compose(Pose.from_record(ego_pose), Pose.from_record(calibrated_sensor))
