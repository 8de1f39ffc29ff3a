"""Training targets: the container, the class grouping of the GT boxes
and the dense assigners.

Port of ``tpu_pillars/ops/target_assigner.py``, in stock torch ops as the
JAX package leaves it to XLA: :func:`assign_targets`, one sample's (A, G)
IoU over every anchor and GT slot, in the flat anchor layout; and
:func:`make_classwise_assigner`, batched over a leading B, each class's
anchor block against its own GT (the assigner the JAX step runs as
"dense"), optionally banded (``band_cells``: each GT against the window of
anchors around its centre only). The windowed assigner on the K5 kernel is
``ops/assign.py``.

Rules (SECOND/PointPillars lineage): an anchor only matches GT boxes of its
own class; IoU >= matched_iou -> positive, IoU < unmatched_iou -> negative,
in between ignored; every valid GT force-matches its best same-class anchor;
regression target = encode(gt, anchor); direction target = [gt yaw > 0].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.anchors import make_anchors
from tpu_pillars_torch.ops.box_coder import encode_boxes
from tpu_pillars_torch.ops.iou import (
    rotated_iou_bev_colchunked, rotated_iou_bev_paired,
)


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


def _force_match(best_anchor, claim, n_anchors: int):
    """Each claiming GT takes its best anchor: best_anchor, claim (R, G)
    -> forced (R, A) bool and forced_gt (R, A) int64, the highest claiming
    GT index on each anchor and -1 elsewhere (the JAX scatter-max rule)."""
    R, G = best_anchor.shape
    dev = best_anchor.device
    at = (best_anchor + torch.arange(R, device=dev)[:, None] * n_anchors
          ).reshape(-1)
    forced = torch.zeros(R * n_anchors, dtype=torch.int32, device=dev)
    forced.scatter_reduce_(0, at, claim.to(torch.int32).reshape(-1), "amax")
    gidx = torch.arange(G, device=dev)
    forced_gt = torch.full((R * n_anchors,), -1, dtype=torch.int64,
                           device=dev)
    forced_gt.scatter_reduce_(0, at, torch.where(claim, gidx, -1).reshape(-1),
                              "amax")
    return (forced.reshape(R, n_anchors) > 0,
            forced_gt.reshape(R, n_anchors))


def _thresholds(config: PillarsConfig, device):
    return (torch.tensor([c.matched_iou for c in config.classes],
                         dtype=torch.float32, device=device),
            torch.tensor([c.unmatched_iou for c in config.classes],
                         dtype=torch.float32, device=device))


class _ClasswiseConsts:
    """The static class-block anchors of one config on one device."""

    def __init__(self, config: PillarsConfig, device):
        anchors, anchor_cls = make_anchors(config)
        C, Y = config.num_classes, len(config.anchor_yaws)
        HW = config.feature_h * config.feature_w
        # (A, 7) laid out (HW, C, Y) -> (C, HW * Y, 7) class blocks
        by_class = (np.asarray(anchors).reshape(HW, C, Y, 7)
                    .transpose(1, 0, 2, 3).reshape(C, HW * Y, 7))
        self.anchors_by_class = torch.from_numpy(
            np.ascontiguousarray(by_class)).to(device)
        cls = torch.from_numpy(np.array(anchor_cls, np.int64)).to(device)
        self.onehot = (cls[None, :] == torch.arange(
            C, device=device)[:, None])                          # (C, A)
        self.matched, self.unmatched = _thresholds(config, device)


@functools.lru_cache(maxsize=8)
def _classwise_consts(config: PillarsConfig, device):
    return _ClasswiseConsts(config, device)


@torch.no_grad()
def assign_targets(anchors, anchor_cls, gt_boxes, gt_cls, gt_valid,
                   config: PillarsConfig, iou_chunk: int = 8192) -> Targets:
    """One sample, every anchor against every GT slot: anchors (A, 7),
    anchor_cls (A,) int; gt_boxes (G, 7), gt_cls (G,) int, gt_valid (G,)
    bool, padded -> feature-major :class:`Targets` (no batch dim).

    The (A, G) IoU, -1 where the classes differ or the slot is invalid:
    ``rotated_iou_bev_chunked``'s values (GT first, ``iou_chunk`` anchors at
    a time) through ``rotated_iou_bev_colchunked``, which clips only the
    pairs that pass the circumradius gate (the rest are exactly 0 either
    way, and at 720,000 anchors clipping every pair is launch-bound);
    each anchor's best GT (ties to the lowest index); each valid GT with a
    positive best IoU force-matches its best anchor (the highest such GT
    index wins an anchor two claim); non-positives encode against
    themselves."""
    A = anchors.shape[0]
    gt_cls = gt_cls.long()
    anchor_cls = anchor_cls.long()
    iou = rotated_iou_bev_colchunked(gt_boxes, anchors, chunk=iou_chunk).T
    eligible = (anchor_cls[:, None] == gt_cls[None, :]) & gt_valid[None, :]
    iou = torch.where(eligible, iou, -1.0)                        # (A, G)

    best_gt = torch.argmax(iou, dim=1)                            # (A,)
    best_iou = torch.gather(iou, 1, best_gt[:, None])[:, 0]
    matched_thr, unmatched_thr = _thresholds(config, anchors.device)
    pos = best_iou >= matched_thr[anchor_cls]
    # anchors with no eligible GT at all (best_iou == -1) are negatives
    neg = (((best_iou >= 0.0) & (best_iou < unmatched_thr[anchor_cls]))
           | (best_iou < 0.0))

    best_anchor = torch.argmax(iou, dim=0)                        # (G,)
    gt_best_iou = torch.gather(iou, 0, best_anchor[None, :])[0]
    del iou
    claim = gt_valid & (gt_best_iou > 0.0)
    forced, forced_gt = _force_match(best_anchor[None], claim[None], A)
    forced, forced_gt = forced[0], forced_gt[0]
    pos = pos | forced
    neg = neg & ~pos
    assigned = torch.where(forced & (forced_gt >= 0), forced_gt, best_gt)

    # non-positive anchors encode against THEMSELVES (residual 0): see
    # make_classwise_assigner
    matched = torch.where(pos[:, None], gt_boxes[assigned], anchors)
    reg = encode_boxes(matched, anchors)                          # (A, 7)
    dirt = (matched[:, 6] > 0.0).to(torch.int32) * pos
    onehot = (gt_cls[assigned][None, :] == torch.arange(
        config.num_classes, device=anchors.device)[:, None])     # (C, A)
    posf = pos.to(torch.float32)
    return Targets(
        cls_onehot=(onehot & pos[None, :]).to(torch.float32),
        reg_targets=reg.T * posf[None, :],
        dir_targets=dirt * pos,
        cls_weights=(pos | neg).to(torch.float32),
        reg_weights=posf,
        num_pos=posf.sum(),
    )


def _banded_iou(config: PillarsConfig, anchors_c, gt_c, band: int):
    """(C, Ac, 7) class-block anchors, (B, C, Gc, 7) GT -> (B, C, Gc, Ac)
    IoU, computed only in each GT's (band x band x yaws) window of anchors
    around its centre (``rotated_iou_bev_paired``) and 0 outside it. The
    window origin is the JAX one: the centre's cell, truncated toward zero,
    less band // 2, clipped into the grid."""
    Hf, Wf = config.feature_h, config.feature_w
    Y = len(config.anchor_yaws)
    C, Ac, _ = anchors_c.shape
    dev = gt_c.device
    stride_x = config.voxel_x * config.head_stride
    stride_y = config.voxel_y * config.head_stride
    r0 = torch.clamp(((gt_c[..., 1] - config.y_min) / stride_y)
                     .to(torch.int32) - band // 2, 0, Hf - band).long()
    c0 = torch.clamp(((gt_c[..., 0] - config.x_min) / stride_x)
                     .to(torch.int32) - band // 2, 0, Wf - band).long()
    ar = torch.arange(band, device=dev)
    rows = r0[..., None, None, None] + ar[:, None, None]
    cols = c0[..., None, None, None] + ar[None, :, None]
    yaws = torch.arange(Y, device=dev)
    win = ((rows * Wf + cols) * Y + yaws).flatten(-3)         # (B,C,Gc,K)
    cls = torch.arange(C, device=dev)[None, :, None, None]
    iou_w = rotated_iou_bev_paired(gt_c, anchors_c[cls, win])  # (B,C,Gc,K)
    dense = gt_c.new_zeros(gt_c.shape[:-1] + (Ac,))
    return dense.scatter_(-1, win, iou_w)


def make_classwise_assigner(config: PillarsConfig, max_gt_per_class: int = 16,
                            iou_chunk: int = 16384, band_cells: int = 0):
    """Returns assign(gt_boxes (B, G, 7), gt_cls (B, G), gt_valid (B, G))
    -> batched feature-major :class:`Targets` on the inputs' device: each
    class's anchor block against its own GT only
    (:func:`group_gt_by_class`, ``max_gt_per_class`` a class), a (B, C, Gc,
    Ac) IoU of ``iou_chunk`` anchors at a time; ineligible pairs (an
    invalid slot) at -1, ties to the lowest index.

    band_cells > 0: BANDED assignment, as the JAX option: each GT's IoU is
    computed only against the (band x band x yaws) window of anchors
    around its centre (:func:`_banded_iou`, band = min(band_cells, feature
    rows, feature columns)) and reads 0 outside it — exact for boxes whose
    reach fits the band; the train step's ``assigner="banded"``. The
    default 0 is the dense IoU."""
    C = config.num_classes
    Y = len(config.anchor_yaws)
    HW = config.feature_h * config.feature_w
    A = config.num_anchors
    Ac = HW * Y
    Gc = max_gt_per_class
    band = min(band_cells, config.feature_h, config.feature_w)

    @torch.no_grad()
    def assign(gt_boxes, gt_cls, gt_valid) -> Targets:
        dev = gt_boxes.device
        k = _classwise_consts(config, dev)
        anchors_c = k.anchors_by_class                          # (C, Ac, 7)
        B = gt_boxes.shape[0]
        gt_c, gv_c = group_gt_by_class(gt_boxes, gt_cls, gt_valid, C, Gc)
        if band > 0:
            iou = _banded_iou(config, anchors_c, gt_c, band)
        else:
            iou = rotated_iou_bev_colchunked(gt_c, anchors_c[None],
                                             chunk=iou_chunk)
        iou = torch.where(gv_c[..., None], iou, -1.0)          # (B,C,Gc,Ac)
        best_gt = torch.argmax(iou, dim=2)                      # (B, C, Ac)
        best_iou = torch.gather(iou, 2, best_gt[:, :, None])[:, :, 0]
        pos = best_iou >= k.matched[:, None]
        best_anchor = torch.argmax(iou, dim=3)                  # (B, C, Gc)
        gt_best_iou = torch.gather(iou, 3, best_anchor[..., None])[..., 0]
        del iou
        claim = gv_c & (gt_best_iou > 0.0)
        forced, forced_gt = _force_match(best_anchor.reshape(B * C, Gc),
                                         claim.reshape(B * C, Gc), Ac)
        forced = forced.reshape(B, C, Ac)
        forced_gt = forced_gt.reshape(B, C, Ac)
        pos = pos | forced
        neg = (best_iou < k.unmatched[:, None]) & ~pos
        assigned = torch.where(forced & (forced_gt >= 0), forced_gt, best_gt)
        # non-positive anchors encode against THEMSELVES (residual 0): padded
        # all-zero GT rows would otherwise give log(0) and 0/0, which a zero
        # regression weight does not cancel (0 * nan = nan)
        picked = torch.gather(gt_c, 2, assigned[..., None].expand(
            B, C, Ac, 7))
        matched = torch.where(pos[..., None], picked, anchors_c[None])
        reg = encode_boxes(matched, anchors_c[None])            # (B,C,Ac,7)
        dirt = (matched[..., 6] > 0.0).to(torch.int32) * pos

        def unblock(x):         # (B, C, HW * Y, ...) -> (B, A, ...)
            rest = x.shape[3:]
            return (x.reshape((B, C, HW, Y) + rest).transpose(1, 2)
                    .reshape((B, A) + rest))

        pos, neg, reg, dirt = (unblock(x) for x in (pos, neg, reg, dirt))
        posf = pos.to(torch.float32)
        return Targets(
            cls_onehot=(k.onehot[None] & pos[:, None, :]).to(torch.float32),
            reg_targets=reg.transpose(1, 2) * posf[:, None, :],
            dir_targets=dirt * pos,
            cls_weights=(pos | neg).to(torch.float32),
            reg_weights=posf,
            num_pos=posf.sum(dim=1),
        )

    return assign
