"""Quaternion math (wxyz convention), NumPy, host-side.

Replaces the reference's external ``pyquaternion`` dependency (SURVEY.md
section 2 'Lyft dataset wrapper'): the dataset layer needs quaternion
compose/rotate for sensor<->ego<->global frame transforms and yaw extraction.
Vectorized: every function accepts (..., 4) stacks.
"""

from __future__ import annotations

import numpy as np


def quat_from_yaw(yaw):
    """Rotation of `yaw` radians about +z. yaw: (...,) -> (..., 4)."""
    yaw = np.asarray(yaw, dtype=np.float64)
    half = yaw / 2.0
    zeros = np.zeros_like(half)
    return np.stack([np.cos(half), zeros, zeros, np.sin(half)], axis=-1)


def quat_from_axis_angle(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.asarray(angle, dtype=np.float64)
    half = angle / 2.0
    return np.concatenate(
        [np.cos(half)[..., None], axis * np.sin(half)[..., None]], axis=-1
    )


def quat_multiply(q1, q2) -> np.ndarray:
    """Hamilton product q1 * q2, both (..., 4) wxyz."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_inverse(q) -> np.ndarray:
    """Inverse of a unit quaternion = conjugate."""
    q = np.asarray(q, dtype=np.float64)
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_to_rotation_matrix(q) -> np.ndarray:
    """(..., 4) -> (..., 3, 3)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    row0 = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return np.stack([row0, row1, row2], axis=-2)


def quat_rotate(q, v) -> np.ndarray:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    R = quat_to_rotation_matrix(q)
    return np.einsum("...ij,...j->...i", R, np.asarray(v, dtype=np.float64))


def yaw_from_quat(q) -> np.ndarray:
    """Heading angle of the box-local +x axis projected onto the xy plane.

    This is how boxes' yaw is recovered from a full 3-D orientation in the
    Lyft/nuScenes devkit convention (SURVEY.md L0: Box orientation is a
    quaternion; the detector works with yaw only).
    """
    fwd = quat_rotate(q, np.array([1.0, 0.0, 0.0]))
    return np.arctan2(fwd[..., 1], fwd[..., 0])
