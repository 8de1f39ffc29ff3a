"""Serving postprocess: own-class sigmoid scores -> per-class threshold ->
static top-k -> decode + direction flip -> class-aware rotated NMS ->
padded detections. Port of ``tpu_pillars/ops/postprocess.py``
(``postprocess_w`` and ``_nms_and_pack``), batched over a leading B dim.

Top-k ties: ``lax.top_k`` breaks ties toward the lowest index, and trained
weights saturate sigmoid scores to exactly 1.0, so ties are common. Both
selections here take the first k of a STABLE descending sort, which has the
same rule; ``torch.topk`` has none.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.box_coder import decode_boxes
from tpu_pillars_torch.ops.nms_overlap import rotated_nms_overlap


class Detections(NamedTuple):
    """Static-size detection sets, (B, D, ...) padded to max_detections."""

    boxes: torch.Tensor      # (B, D, 7)
    scores: torch.Tensor     # (B, D)
    class_ids: torch.Tensor  # (B, D) int32
    valid: torch.Tensor      # (B, D) bool


def wrap_angle(a):
    """Wrap to [-pi, pi) with a floor-mod: fmod, then shift negative
    remainders by the (positive) divisor — the JAX package's remainder,
    operation for operation."""
    two_pi = 2 * math.pi
    r = torch.fmod(a + math.pi, two_pi)
    r = torch.where(r < 0, r + two_pi, r)
    return r - math.pi


def top_k_stable(x, k: int):
    """(B, n) -> (values, indices) of the k largest along the last dim,
    ties toward the lowest index (``lax.top_k``'s rule)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _top_candidates(own_logits, anchor_cls, config: PillarsConfig):
    """Own-class logits (B, A) -> thresholded scores, static top-K."""
    scores = torch.sigmoid(own_logits)
    thresholds = torch.tensor([c.score_threshold for c in config.classes],
                              dtype=own_logits.dtype,
                              device=own_logits.device)[anchor_cls]
    masked = torch.where(scores >= thresholds, scores, -1.0)
    top_scores, top_idx = top_k_stable(masked, config.pre_nms_top_k)
    return top_scores, top_idx, top_scores > 0.0


def postprocess_w(own, box_p, dir_p, anchors, anchor_cls,
                  config: PillarsConfig) -> Detections:
    """Serving-wire postprocess: own (B, A) own-class logits in CANONICAL
    anchor order (a = hw * A_loc + a_loc); box_p (B, 7, A), dir_p (B, 2, A)
    feature-major in the PERMUTED order (a'' = a_loc * HW + hw); anchors
    (A, 7) and anchor_cls (A,) long, canonical, on the same device."""
    top_scores, top_idx, cand_valid = _top_candidates(own, anchor_cls,
                                                      config)
    a = own.shape[-1]
    a_loc = config.anchors_per_loc
    hw = a // a_loc
    p_idx = (top_idx % a_loc) * hw + top_idx // a_loc           # (B, K)

    def take_cols(t):                                          # (B, r, K)
        rows = t.shape[1]
        return torch.gather(t, 2, p_idx[:, None, :].expand(-1, rows, -1))

    boxes = decode_boxes(take_cols(box_p).transpose(1, 2), anchors[top_idx])
    dir_cls = torch.argmax(take_cols(dir_p), dim=1)
    cls_of = anchor_cls[top_idx]
    return _nms_and_pack(boxes, dir_cls, cls_of, top_scores, cand_valid,
                         config)


def _nms_and_pack(boxes, dir_cls, cls_of, top_scores, cand_valid,
                  config: PillarsConfig) -> Detections:
    D = config.max_detections
    flip = (boxes[..., 6] > 0).to(dir_cls.dtype) != dir_cls
    yaw = wrap_angle(boxes[..., 6] + torch.where(flip, math.pi, 0.0))
    boxes = torch.cat([boxes[..., :6], yaw[..., None]], dim=-1)

    # class-aware NMS: translate each class into its own distant BEV region
    span = (config.x_max - config.x_min) + (config.y_max - config.y_min)
    shifted = boxes.clone()
    shifted[..., 0] = boxes[..., 0] + cls_of.to(boxes.dtype) * (4.0 * span)
    keep = rotated_nms_overlap(shifted, cand_valid,
                               config.nms_iou_threshold, class_ids=cls_of,
                               class_gap=4.0 * span)

    final_scores = torch.where(keep, top_scores, -1.0)
    det_scores, det_idx = top_k_stable(final_scores, D)
    det_valid = det_scores > 0.0
    det_boxes = torch.gather(boxes, 1, det_idx[..., None].expand(-1, -1, 7))
    return Detections(
        boxes=det_boxes * det_valid[..., None],
        scores=torch.where(det_valid, det_scores, 0.0),
        class_ids=(torch.gather(cls_of, 1, det_idx) * det_valid).to(
            torch.int32),
        valid=det_valid,
    )
