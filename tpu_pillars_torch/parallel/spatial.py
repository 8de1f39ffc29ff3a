"""Pillar-axis (spatial) sharding of the detector front end. Port of
``tpu_pillars/parallel/spatial.py``.

Data parallelism (``parallel.eval_dp`` / ``train_dp``) scales over
sweeps; this scales over ONE sweep's extent. Each rank owns a contiguous
band of BEV rows. The host splits the cloud by row band
(:func:`split_points_by_slab`, order-preserving, so the pillarizer's
within-pillar order is untouched). Each rank builds the canvas of its band
with the port's own canvas function (``detector.build_canvas_fn``), as a
batch of one under its own ``max_pillars`` budget, and one all-reduce sums
the ranks' canvases. A cell lives in exactly one band, so the canvases'
supports are disjoint and each sum adds a feature to zeros: with no
budget overflow the canvas is bit-identical to one device's.

Under overflow the budget is per band (n_ranks x ``max_pillars`` in all),
more capacity than one device, which is the point: a cloud that overflows
one device's budget is kept whole as long as no band overflows.

The RPN, the head and the postprocess run replicated after the sum (every
rank computes the same boxes). A bf16 canvas is summed in f32 and cast
back, which is exact for disjoint supports.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.detector import (
    build_canvas_fn, build_model_fn, build_postprocess_fn, pack_detections,
)
from tpu_pillars_torch.parallel.mesh import Mesh


def split_points_by_slab(
    points: np.ndarray,
    config: PillarsConfig,
    n_shards: int,
    capacity: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Host-side splitter: one cloud -> per-shard padded clouds by BEV row
    band.

    points: (M, F) float32. Rows are binned as the pillarizer bins them
    (floor((y - y_min) / voxel_y)); shard k owns rows [k*H/n, (k+1)*H/n).
    Out-of-range points (the range crop, z gate included) are dropped
    here; the device would drop them anyway. Input order is kept within
    each shard, so each pillar's point order matches the unsharded
    pillarizer bit for bit.

    Returns (shard_points (n, capacity, F) f32 zero-padded, counts (n,)
    int32, info) with info = {"dropped_range": int, "dropped_capacity":
    int}. capacity defaults to config.max_points (one device's budget per
    shard)."""
    points = np.asarray(points, np.float32)
    if points.ndim != 2:
        raise ValueError(f"points must be (M, F), got {points.shape}")
    H, W = config.grid_h, config.grid_w
    if H % n_shards != 0:
        raise ValueError(f"grid_h={H} not divisible by n_shards={n_shards}")
    band = H // n_shards
    capacity = config.max_points if capacity is None else int(capacity)

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    col = np.floor((x - config.x_min) / config.voxel_x).astype(np.int64)
    row = np.floor((y - config.y_min) / config.voxel_y).astype(np.int64)
    in_range = (
        (col >= 0) & (col < W) & (row >= 0) & (row < H)
        & (z >= config.z_min) & (z <= config.z_max)
    )
    kept = points[in_range]
    shard = row[in_range] // band

    out = np.zeros((n_shards, capacity, points.shape[1]), np.float32)
    counts = np.zeros((n_shards,), np.int32)
    dropped_capacity = 0
    for k in range(n_shards):
        mine = kept[shard == k]          # order-preserving boolean take
        n_k = min(len(mine), capacity)
        dropped_capacity += len(mine) - n_k
        out[k, :n_k] = mine[:n_k]
        counts[k] = n_k
    info = {
        "dropped_range": int(len(points) - len(kept)),
        "dropped_capacity": int(dropped_capacity),
    }
    return out, counts, info


def _band_canvas(canvas_fn, points, num_points, mesh: Mesh):
    """This rank's band (row ``mesh.rank`` of the (n, M, F) split) through
    ``canvas_fn`` as a batch of one, then the canvases summed over the
    ranks -> (H, W, C) in the canvas's dtype."""
    if len(points) != mesh.size:
        raise ValueError(f"{len(points)} bands for {mesh.size} ranks")
    pts = torch.as_tensor(points[mesh.rank])
    n = torch.as_tensor(num_points[mesh.rank:mesh.rank + 1])
    canvas = canvas_fn(pts[None].to(mesh.device, torch.float32),
                       n.to(mesh.device, torch.int64))[0]
    return mesh.all_reduce_(canvas.float()).to(canvas.dtype)


def make_spatial_frontend(config: PillarsConfig, mesh: Mesh,
                          axis_name: str = "data",
                          use_pallas_pfn: bool = True,
                          fused_frontend: Optional[bool] = None):
    """Returns f(model, points (n, M, F), num_points (n,)) -> BEV canvas
    (H, W, C) f32, the same on every rank.

    ``points`` is :func:`split_points_by_slab`'s output (leading axis: the
    ranks). Each rank builds the canvas of its band with the front end the
    ``Detector`` runs (``detector.build_canvas_fn``: fused, or classic
    with K6 or the plain PillarFeatureNet); one all-reduce sums them."""
    mesh.check_axis(axis_name)

    def frontend(model, points, num_points):
        canvas_fn = build_canvas_fn(model, config,
                                    use_pallas_pfn=use_pallas_pfn,
                                    fused_frontend=fused_frontend)
        return _band_canvas(canvas_fn, points, num_points, mesh)

    return frontend


def make_spatial_detector_fn(config: PillarsConfig, mesh: Mesh,
                             axis_name: str = "data",
                             dtype=torch.float32,
                             use_pallas_pfn: bool = True,
                             fused_frontend: Optional[bool] = None,
                             nms_impl: str = "auto"):
    """Returns f(model, points (n, M, F), num_points (n,)) -> packed
    detections (max_detections, 10), the same on every rank: one cloud in,
    boxes out, the front end sharded over the ranks' row bands.

    The ``Detector``'s two stages: stage 1 = the sharded front end and the
    all-reduce, then the RPN and the wire head (in ``dtype``) replicated;
    stage 2 = decode + NMS + pack. Unpack with
    ``detector.packed_to_boxes``."""
    mesh.check_axis(axis_name)
    post = build_postprocess_fn(config, mesh.device, nms_impl)

    def predict_packed(model, points, num_points) -> torch.Tensor:
        stage1 = build_model_fn(model, config, use_pallas_pfn=use_pallas_pfn,
                                fused_frontend=fused_frontend, dtype=dtype)
        canvas = _band_canvas(stage1.canvas, points, num_points, mesh)
        return pack_detections(post(*stage1.wire(canvas[None])))[0]

    return predict_packed
