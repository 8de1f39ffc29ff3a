"""Online multi-sweep accumulation for streaming serving — copy of
``tpu_pillars/data/stream.py``, the online counterpart of
``data.lyft.LyftDataset.load_sweeps``.

Offline evaluation walks a recorded sample_data chain backwards from each
keyframe; a deployed detector instead receives sweeps forward in time, one
per lidar revolution, and must assemble the same accumulated cloud for the
newest sweep. SweepAccumulator keeps the last `num_sweeps` raw sweeps with
their poses and re-expresses them in the newest sweep's lidar frame with
the same dt channel — bit for bit the cloud load_sweeps builds for that
keyframe (tests/test_torch_serving.py holds it on a fixture dataset), so a
detector of a multi-sweep config serves streaming input unchanged. The
server's ``/sweep`` endpoint (``serve.py``) keeps one per stream.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Tuple

import numpy as np

from tpu_pillars_torch.geometry.transforms import (
    Pose, compose, inverse, transform_points,
)


class SweepAccumulator:
    """Rolling buffer of the last `num_sweeps` lidar sweeps.

    push(points, lidar_to_global, timestamp_us) -> (N_total, F+1) cloud:
    every buffered sweep transformed into the NEWEST sweep's lidar frame,
    newest first (load_sweeps order), with the per-sweep time lag appended
    as the last column in seconds (timestamps arrive in microseconds, the
    Lyft table unit). Feature columns beyond xyz pass through untouched.
    """

    def __init__(self, num_sweeps: int):
        if num_sweeps < 1:
            raise ValueError(f"num_sweeps must be >= 1; got {num_sweeps}")
        self.num_sweeps = num_sweeps
        self._buf: Deque[Tuple[np.ndarray, Pose, float]] = deque(
            maxlen=num_sweeps)

    def __len__(self) -> int:
        return len(self._buf)

    def reset(self) -> None:
        """Drop all buffered sweeps (scene change / tracking reset)."""
        self._buf.clear()

    def push(self, points: np.ndarray, lidar_to_global: Pose,
             timestamp_us: float) -> np.ndarray:
        """Ingest the newest sweep; return the accumulated cloud in ITS
        lidar frame."""
        points = np.asarray(points, dtype=np.float32)
        if points.ndim != 2 or points.shape[1] < 3:
            raise ValueError(f"points must be (N, >=3); got {points.shape}")
        self._buf.append((points, lidar_to_global, float(timestamp_us)))

        ref_pose_inv = inverse(lidar_to_global)
        ref_t = float(timestamp_us)
        clouds = []
        for pts, pose, t in reversed(self._buf):      # newest -> oldest
            rel = compose(ref_pose_inv, pose)
            moved = transform_points(rel, pts)
            dt = np.full((len(pts), 1), (ref_t - t) * 1e-6, np.float32)
            clouds.append(np.concatenate([moved, dt], axis=1))
        return np.concatenate(clouds, axis=0).astype(np.float32)
