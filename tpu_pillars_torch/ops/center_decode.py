"""CenterPoint's postprocess: the dense head maps -> per-task candidates ->
rotated NMS -> padded detections with velocity. Static shapes throughout,
batched over (sample, task) rows.

Per (sample, task), as the published ``CenterHead.predict`` decodes
(arXiv:2006.11275; ``det3d/models/bbox_heads/center_head.py``):

* the heatmap's sigmoid, and at each cell the score and class of the max
  over the task's classes (ties to the lower class);
* a cell is a candidate when its score is above ``score_threshold`` and its
  centre lies within ``post_center_limit`` in x and y and
  ``post_center_limit_z`` in z;
* the first ``nms_pre`` candidates of a stable descending sort
  (``top_k_stable``: ties to the lowest cell index);
* their boxes: x = ((col + reg_x) * out_stride) * voxel_x + x_min (y
  likewise from the row), z = height, (w, l, h) = exp(dim), yaw =
  atan2(rot_sin, rot_cos), and the velocity (vx, vy).

Then greedy rotated BEV NMS at ``nms_iou`` over every (sample, task) row in
one call (``nms_impl``: K4 and the ``nms_scan`` keep on the card, the
dense IoU and the fixpoint loop on the CPU, as for PointPillars), and the
first ``nms_post`` kept of each row in score order. A sample's detections
are its tasks' rows one after the other: ``num_tasks * nms_post`` slots.

While tracing is on, the counters ``center.candidates`` (cells over the
threshold and inside the limit, summed over tasks, before the ``nms_pre``
cut) and ``center.kept`` (detections after NMS) count, read without a
synchronise; the spans ``detector.decode`` and ``detector.nms`` time the
two halves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_pillars_torch.config import CenterPointConfig
from tpu_pillars_torch.models.centerpoint import map_layout
from tpu_pillars_torch.ops.nms import rotated_nms_batched
from tpu_pillars_torch.ops.nms_overlap import rotated_nms_overlap
from tpu_pillars_torch.ops.postprocess import resolve_nms_impl, top_k_stable
from tpu_pillars_torch.utils import profiling
from tpu_pillars_torch.utils.profiling import span


class CenterDetections(NamedTuple):
    """Static-size detection sets, (B, D, ...), D = tasks x ``nms_post``."""

    boxes: torch.Tensor      # (B, D, 7) [x, y, z, w, l, h, yaw]
    scores: torch.Tensor     # (B, D)
    class_ids: torch.Tensor  # (B, D) int32, over all tasks' classes
    valid: torch.Tensor      # (B, D) bool
    velocity: torch.Tensor   # (B, D, 2) [vx, vy]


class Candidates(NamedTuple):
    """The top ``nms_pre`` cells of every (sample, task) row, score
    order."""

    boxes: torch.Tensor      # (B * T, K, 7)
    scores: torch.Tensor     # (B * T, K), -1 where invalid
    labels: torch.Tensor     # (B * T, K) long, class within the task
    velocity: torch.Tensor   # (B * T, K, 2)
    valid: torch.Tensor      # (B * T, K) bool


def center_xyz(maps, layout, config: CenterPointConfig):
    """The centre of every cell's box: (B, T, H, W) x, y, z."""
    B, _, H, W = maps.shape
    reg = maps[:, layout["reg"]]                          # (B, T, 2, H, W)
    cols = torch.arange(W, device=maps.device, dtype=maps.dtype)
    rows = torch.arange(H, device=maps.device, dtype=maps.dtype)
    x = ((cols + reg[:, :, 0]) * float(config.out_stride)) * config.voxel_x \
        + config.x_min
    y = ((rows[:, None] + reg[:, :, 1]) * float(config.out_stride)) \
        * config.voxel_y + config.y_min
    return x, y, maps[:, layout["height"][:, 0]]


@functools.lru_cache(maxsize=None)
def _constants(config: CenterPointConfig, device: torch.device):
    """The map layout, which tasks have a second class, and each task's
    first class, on ``device``, made once (a copy to the card from the
    host would wait for the card's queue)."""
    layout = {k: v.to(device) for k, v in map_layout(config).items()}
    two = torch.tensor([len(t.classes) > 1 for t in config.tasks],
                       device=device)[None, :, None, None]
    first = torch.tensor([0] + [len(t.classes) for t in config.tasks][:-1],
                         device=device).cumsum(0)
    return layout, two, first


def candidates(maps, config: CenterPointConfig) -> Candidates:
    """Dense maps (B, C, H, W) (``models.centerpoint.map_layout``) ->
    :class:`Candidates`."""
    layout, two, _ = _constants(config, maps.device)
    B, _, H, W = maps.shape
    T, K = config.num_tasks, config.nms_pre
    hm = torch.sigmoid(maps[:, layout["hm"]])             # (B, T, 2, H, W)
    s0 = hm[:, :, 0]
    s1 = torch.where(two, hm[:, :, 1], -1.0)
    label = (s1 > s0).long()
    score = torch.maximum(s0, s1)
    x, y, z = center_xyz(maps, layout, config)
    lim, lim_z = config.post_center_limit, config.post_center_limit_z
    inside = ((x >= -lim) & (x <= lim) & (y >= -lim) & (y <= lim)
              & (z >= -lim_z) & (z <= lim_z))
    keep = (score > config.score_threshold) & inside
    if profiling.recording():
        profiling.count_device("center.candidates", keep.sum())
    key = torch.where(keep, score, -1.0).reshape(B * T, H * W)
    top_scores, top_idx = top_k_stable(key, K)

    def take(t):                                          # (B, T, r, H, W)
        r = t.shape[2]
        flat = t.reshape(B * T, r, H * W)
        return torch.gather(flat, 2, top_idx[:, None, :].expand(-1, r, -1))

    xyz = take(torch.stack([x, y, z], dim=2))             # (BT, 3, K)
    dim = torch.exp(take(maps[:, layout["dim"]]))
    rot = take(maps[:, layout["rot"]])
    yaw = torch.atan2(rot[:, 0], rot[:, 1])
    boxes = torch.cat([xyz, dim, yaw[:, None]], dim=1).transpose(1, 2)
    vel = take(maps[:, layout["vel"]]).transpose(1, 2)
    lab = torch.gather(label.reshape(B * T, H * W), 1, top_idx)
    return Candidates(boxes.contiguous(), top_scores, lab, vel.contiguous(),
                      top_scores > 0.0)


def nms_and_pack(c: Candidates, batch: int, config: CenterPointConfig,
                 nms_impl: str) -> CenterDetections:
    """Rotated NMS over every row of ``c`` in one call, then the first
    ``nms_post`` kept a row, a sample's tasks one after the other."""
    if resolve_nms_impl(nms_impl, c.boxes.device) == "pallas":
        keep = rotated_nms_overlap(c.boxes, c.valid, config.nms_iou)
    else:
        keep = rotated_nms_batched(c.boxes, c.valid, config.nms_iou)
    final = torch.where(keep, c.scores, -1.0)
    scores, idx = top_k_stable(final, config.nms_post)
    valid = scores > 0.0
    if profiling.recording():
        profiling.count_device("center.kept", valid.sum())
    T = config.num_tasks
    offsets = _constants(config, idx.device)[2].repeat(batch)

    def take(t):
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[2]))

    boxes = take(c.boxes) * valid[..., None]
    vel = take(c.velocity) * valid[..., None]
    cls = (torch.gather(c.labels, 1, idx) + offsets[:, None]) * valid
    D = T * config.nms_post
    return CenterDetections(
        boxes=boxes.reshape(batch, D, 7),
        scores=torch.where(valid, scores, 0.0).reshape(batch, D),
        class_ids=cls.to(torch.int32).reshape(batch, D),
        valid=valid.reshape(batch, D),
        velocity=vel.reshape(batch, D, 2))


def center_postprocess(maps, config: CenterPointConfig,
                       nms_impl: str = "auto") -> CenterDetections:
    """Dense maps (B, C, H, W) -> :class:`CenterDetections`, in the spans
    ``detector.decode`` and ``detector.nms``."""
    with span("detector.decode", device=maps.device):
        c = candidates(maps, config)
    with span("detector.nms", device=maps.device):
        return nms_and_pack(c, maps.shape[0], config, nms_impl)
