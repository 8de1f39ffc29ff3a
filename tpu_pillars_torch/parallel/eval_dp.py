"""Data-parallel evaluation: each rank detects its shard of the sweeps,
then one ``all_gather`` returns every shard's detections to every rank.
Port of ``tpu_pillars/parallel/eval_dp.py``.

The mAP protocol itself stays host numpy (``evaluation.map_eval``);
``evaluation.pipeline.evaluate_dataset(mesh=)`` runs on every rank and
scores the gathered detections.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.detector import (
    build_forward_fn, build_model_fn, build_postprocess_fn, pack_detections,
)
from tpu_pillars_torch.ops.postprocess import Detections
from tpu_pillars_torch.parallel.mesh import Mesh, local_shard


def _local_inputs(points, num_points, mesh: Mesh):
    """This rank's slice of the global (B, M, F) points and (B,) counts,
    on its device: f32 points, int64 counts."""
    pts, n = local_shard((points, num_points), mesh)
    return (torch.as_tensor(pts).to(mesh.device, torch.float32),
            torch.as_tensor(n).to(mesh.device, torch.int64))


def make_dp_packed_detector(config: PillarsConfig, mesh: Mesh,
                            axis_name: str = "data"):
    """Returns f(model, points (B, M, F), num_points (B,)) -> packed
    detections (B, D, 10) on the rank's device, the same on every rank; B
    must divide by the mesh size and ``model`` (a ``PointPillars``) lie on
    the rank's device.

    The two stages of ``detector.Detector``: stage 1 runs the batched model
    (``build_model_fn``) on this rank's B/R sweeps, stage 2 decodes, runs
    NMS and packs them, then one tiled all-gather concatenates the ranks'
    (B/R, D, 10) in rank order."""
    mesh.check_axis(axis_name)
    post = build_postprocess_fn(config, mesh.device)

    def predict_packed_batch(model, points, num_points) -> torch.Tensor:
        pts, n = _local_inputs(points, num_points, mesh)
        stage1 = build_model_fn(model, config)
        return mesh.all_gather(pack_detections(post(*stage1(pts, n))))

    return predict_packed_batch


def make_dp_detector_fn(config: PillarsConfig, mesh: Mesh,
                        axis_name: str = "data"):
    """Returns f(model, points (B, M, F), num_points (B,)) -> Detections
    with leading dim B (global) on every rank: each rank detects its B/R
    sweeps (``build_forward_fn``), and each field is all-gathered."""
    mesh.check_axis(axis_name)

    def detect(model, points, num_points) -> Detections:
        pts, n = _local_inputs(points, num_points, mesh)
        det = build_forward_fn(model, config)(pts, n)
        return Detections(*(mesh.all_gather(t) for t in det))

    return detect
