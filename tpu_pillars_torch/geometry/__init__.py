from tpu_pillars_torch.geometry.quaternion import (
    quat_from_yaw,
    quat_from_axis_angle,
    quat_multiply,
    quat_inverse,
    quat_rotate,
    quat_to_rotation_matrix,
    yaw_from_quat,
)
from tpu_pillars_torch.geometry.boxes import Box3D, box_corners_bev, box_corners_3d
from tpu_pillars_torch.geometry.transforms import Pose, compose, inverse, transform_points

__all__ = [
    "quat_from_yaw", "quat_from_axis_angle", "quat_multiply", "quat_inverse",
    "quat_rotate", "quat_to_rotation_matrix", "yaw_from_quat",
    "Box3D", "box_corners_bev", "box_corners_3d",
    "Pose", "compose", "inverse", "transform_points",
]
