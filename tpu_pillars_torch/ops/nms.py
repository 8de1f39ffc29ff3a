"""Greedy rotated NMS as a fixpoint — port of ``tpu_pillars/ops/nms.py``.

Greedy keeping is the unique solution of

    keep_i = valid_i  AND  no j < i with (keep_j AND over_ji)

over score-sorted candidates; iterating that equation from keep = valid
until it stops changing gives the sequential greedy result (a suppressed box
never suppresses; ties break by lowest index). Each sweep is one masked
any-reduction over the (K, K) overlap matrix, batched over samples; the loop
ends when no sample changed, which costs one host sync per sweep (typically
< 8 sweeps).

:func:`rotated_nms` is the JAX package's single-set entry: the dense IoU
matrix (the arithmetic of ``ops.iou.rotated_iou_bev_chunked``, stock torch
ops, as the JAX package leaves it to XLA), the strict upper triangle above
the threshold, then the fixpoint. :func:`rotated_nms_batched` is the same
on every sample of a batch at once (the postprocess's ``nms_impl=
"fixpoint"``). The serving path's batched, class-blocked NMS on the K4
overlap kernel is ``ops.nms_overlap.rotated_nms_overlap``.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.ops.iou import rotated_iou_bev_colchunked


def nms_fixpoint(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """over (B, K, K) bool, over[b, j, i]: higher-ranked j suppresses i;
    valid (B, K) bool -> keep (B, K) bool. The op
    ``tpu_pillars::nms_fixpoint`` (``_build.kernel_op``), whose
    implementation on either device is :func:`nms_fixpoint_loop`:
    ``torch.export`` refuses the loop's host-side test, and records the
    op."""
    return _NMS_FIXPOINT(over, valid)


def nms_fixpoint_loop(over: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """The sweep until the keep mask stops changing."""
    k = valid.shape[-1]
    over_f = over.to(torch.float32)
    keep = valid
    for _ in range(k):
        # suppressed_i = any_j keep_j & over_ji, as a 0/1 count (exact in f32
        # up to 2^24 suppressors)
        hits = torch.matmul(keep.to(torch.float32)[:, None, :], over_f)[:, 0]
        new_keep = valid & ~(hits > 0.0)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    # an op's output may not be its input (nothing was suppressed)
    return keep.clone() if keep is valid else keep


_NMS_FIXPOINT = _build.kernel_op("nms_fixpoint", nms_fixpoint_loop,
                                 nms_fixpoint_loop,
                                 lambda over, valid: torch.empty_like(valid))


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy rotated BEV NMS over one score-sorted set: boxes (K, 7) in
    descending score order, scores (K,) (unused: the order is positional),
    valid (K,) bool (never kept, never suppressing) -> keep (K,) bool."""
    del scores
    return rotated_nms_batched(boxes[None], valid[None], iou_threshold)[0]


def rotated_nms_batched(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """:func:`rotated_nms` on each sample of boxes (B, K, 7), valid (B, K)
    -> keep (B, K), one IoU pass and one fixpoint for the batch. Pair (j,
    i) rounds as ``rotated_iou_bev_chunked(boxes, boxes)[j, i]``, i.e.
    ``rotated_iou_bev``'s arithmetic with box i first; 256 columns at a
    time."""
    K = boxes.shape[-2]
    iou = rotated_iou_bev_colchunked(boxes, boxes,
                                     chunk=min(K, 256)).transpose(-1, -2)
    idx = torch.arange(K, device=boxes.device)
    over = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    return nms_fixpoint(over, valid)
