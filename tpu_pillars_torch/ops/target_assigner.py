"""Training targets and class grouping of the GT boxes.

Port of the container and grouping parts of
``tpu_pillars/ops/target_assigner.py``. The assignment itself (K5 plus its
epilogue) is ``ops/assign.py``.

Rules (SECOND/PointPillars lineage): an anchor only matches GT boxes of its
own class; IoU >= matched_iou -> positive, IoU < unmatched_iou -> negative,
in between ignored; every valid GT force-matches its best same-class anchor;
regression target = encode(gt, anchor); direction target = [gt yaw > 0].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Targets(NamedTuple):
    """Per-anchor training targets, FEATURE-MAJOR (the anchor axis last),
    with a leading batch dim when batched."""

    cls_onehot: torch.Tensor   # (C, A) one-hot (zeros for negatives)
    reg_targets: torch.Tensor  # (7, A)
    dir_targets: torch.Tensor  # (A,) int32 in {0, 1}
    cls_weights: torch.Tensor  # (A,) 1 for pos+neg, 0 for ignored
    reg_weights: torch.Tensor  # (A,) 1 for pos
    num_pos: torch.Tensor      # () float


def group_gt_by_class(gt_boxes, gt_cls, gt_valid, num_classes: int,
                      cap: int):
    """(B, G, 7) mixed -> per-class (B, C, cap, 7) boxes + (B, C, cap)
    validity. A class keeps its first ``cap`` valid GT in input order; the
    rest are dropped."""
    B, G, _ = gt_boxes.shape
    dev = gt_boxes.device
    cls = gt_cls.long()
    onehot = ((cls[..., None] == torch.arange(num_classes, device=dev))
              & gt_valid[..., None]).to(torch.int32)            # (B, G, C)
    rank_all = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(rank_all, 2, cls.clamp(0, num_classes - 1)[..., None]
                        )[..., 0]
    ok = gt_valid & (rank < cap) & (cls >= 0) & (cls < num_classes)
    slots = num_classes * cap
    dest = torch.where(ok, cls * cap + rank, slots)             # (B, G)
    flat = dest + torch.arange(B, device=dev)[:, None] * (slots + 1)
    boxes = torch.zeros((B * (slots + 1), 7), dtype=gt_boxes.dtype,
                        device=dev)
    valid = torch.zeros((B * (slots + 1),), dtype=torch.bool, device=dev)
    boxes[flat.reshape(-1)] = gt_boxes.reshape(-1, 7)
    valid[flat.reshape(-1)] = ok.reshape(-1)
    boxes = boxes.reshape(B, slots + 1, 7)[:, :slots]
    valid = valid.reshape(B, slots + 1)[:, :slots]
    return (boxes.reshape(B, num_classes, cap, 7),
            valid.reshape(B, num_classes, cap))
