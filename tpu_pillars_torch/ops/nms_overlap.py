"""K4 NMS overlap matrix + class-blocked rotated NMS.

Port of ``tpu_pillars/ops/nms_pallas.py``. :func:`overlap_matrix` gives, for
each sample of a batch of score-sorted candidates, the 0/1 matrix
``over[j, i] = (rotated BEV IoU > thr) & (j < i)``. On a CUDA tensor it
launches ``csrc/nms_overlap.cu`` (one launch for all samples; only tiles
on or above the diagonal launch, each writing its mirrored tile's zeros,
and only the pairs that pass the circumradius gate run the clipping
arithmetic; each block computes its boxes' :func:`payloads` itself, so
the wrapper is one launch); on a CPU tensor it runs
:func:`overlap_matrix_plain`.
The kernel is built with no fused multiply-adds, as eager torch rounds, so
the two agree except for pairs whose IoU sits within rounding of the
threshold.

:func:`rotated_nms_overlap` permutes candidates into class-blocked order
first (exact when classes cannot overlap — the class-aware shift of
``ops.postprocess`` guarantees that unless a decoded box out-spans the
shift, which the ``class_gap`` guard checks), then the greedy keep of
``ops.nms.nms_fixpoint`` over the matrix: on the card the scan kernel
``csrc/nms_scan.cu``, one launch after K4's and no read back to the host,
so the call returns before the card has run it; on the CPU the fixpoint
loop. :func:`rotated_nms_pallas` is its one-sample form, with the JAX
function's name and signature.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.ops.iou import (
    _EPS, _half_edge_integral, corners_bev,
)
from tpu_pillars_torch.ops.nms import nms_fixpoint

PAYLOAD = 12   # corner xs (4), corner ys (4), centre (2), BEV area, radius


def payloads(boxes):
    """boxes (B, K, 7) -> (B, K, 12): corner xs, corner ys, centre x/y,
    BEV area, circumradius — the per-box inputs of the overlap test."""
    corners = corners_bev(boxes)                          # (B, K, 4, 2)
    area = boxes[..., 3] * boxes[..., 4]
    circ = 0.5 * torch.sqrt(boxes[..., 3] ** 2 + boxes[..., 4] ** 2)
    return torch.cat([corners[..., 0], corners[..., 1], boxes[..., 0:2],
                      area[..., None], circ[..., None]], dim=-1)


def overlap_matrix(boxes, iou_threshold: float):
    """(B, K, 7) score-sorted f32 boxes -> (B, K, K) bool. The op
    ``tpu_pillars::overlap_matrix`` (``_build.kernel_op``):
    :func:`overlap_matrix_cuda` on a CUDA tensor,
    :func:`overlap_matrix_plain` on a CPU tensor."""
    if boxes.dim() != 3 or boxes.shape[-1] != 7 \
            or boxes.dtype != torch.float32:
        raise ValueError(f"overlap_matrix wants float32 boxes (B, K, 7), got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    return _OVERLAP_MATRIX(boxes, float(iou_threshold))


def overlap_matrix_cuda(boxes: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """K4's launch, the CUDA implementation of
    ``tpu_pillars::overlap_matrix``."""
    B, K, _ = boxes.shape
    out = torch.empty((B, K, K), dtype=torch.bool, device=boxes.device)
    _build.launch("nms_overlap", "nms_overlap", "ppiif", boxes.contiguous(),
                  out, B, K, iou_threshold)
    return out


def _overlap_matrix_fake(boxes, iou_threshold):
    B, K, _ = boxes.shape
    return boxes.new_empty((B, K, K), dtype=torch.bool)


def overlap_matrix_plain(boxes, iou_threshold: float):
    """Plain PyTorch version of :func:`overlap_matrix`: the kernel's
    arithmetic (per-pair recentring, both half-edge integrals, the
    circumradius gate as ``sep > 0``) over the whole pair matrix."""
    B, K, _ = boxes.shape
    pay = payloads(boxes)
    pj = pay[:, :, None, :]                                   # rows j
    pi = pay[:, None, :, :]                                   # cols i
    dx = pj[..., 8] - pi[..., 8]
    dy = pj[..., 9] - pi[..., 9]
    rr = pj[..., 11] + pi[..., 11]
    sep = dx * dx + dy * dy - rr * rr

    jpx = [pj[..., q] for q in range(4)]
    jpy = [pj[..., 4 + q] for q in range(4)]
    ipx = [pi[..., q] for q in range(4)]
    ipy = [pi[..., 4 + q] for q in range(4)]
    midx = 0.125 * (jpx[0] + jpx[1] + jpx[2] + jpx[3]
                    + ipx[0] + ipx[1] + ipx[2] + ipx[3])
    midy = 0.125 * (jpy[0] + jpy[1] + jpy[2] + jpy[3]
                    + ipy[0] + ipy[1] + ipy[2] + ipy[3])
    jpx = [x - midx for x in jpx]
    jpy = [y - midy for y in jpy]
    ipx = [x - midx for x in ipx]
    ipy = [y - midy for y in ipy]
    inter = (_half_edge_integral(jpx, jpy, ipx, ipy)
             + _half_edge_integral(ipx, ipy, jpx, jpy))
    inter = torch.clamp(inter, min=0.0)
    inter = torch.where(sep > 0.0, 0.0, inter)
    aj, ai = pj[..., 10], pi[..., 10]
    inter = torch.minimum(inter, torch.minimum(aj, ai))
    union = torch.clamp(aj + ai - inter, min=_EPS)
    iou = torch.clamp(inter / union, 0.0, 1.0)
    idx = torch.arange(K, device=boxes.device)
    return (iou > iou_threshold) & (idx[:, None] < idx[None, :])


_OVERLAP_MATRIX = _build.kernel_op(
    "overlap_matrix", overlap_matrix_cuda, overlap_matrix_plain,
    _overlap_matrix_fake)


def rotated_nms_overlap(boxes, valid, iou_threshold: float, class_ids=None,
                        class_gap: float = 0.0):
    """Greedy rotated NMS over score-sorted candidates, batched.

    boxes (B, K, 7) sorted by descending score, valid (B, K) bool,
    class_ids (B, K) int (optional) -> keep (B, K) bool.

    With class_ids, candidates are first permuted into class-blocked order
    (class-major, score order within a class), exact when cross-class pairs
    cannot overlap. The permutation applies only to samples where
    2 * max(valid circumradius) < class_gap; elsewhere it is the identity."""
    B, K, _ = boxes.shape
    if class_ids is not None:
        iota = torch.arange(K, device=boxes.device)
        perm = torch.argsort(class_ids.long() * K + iota, dim=1)
        if class_gap > 0.0:
            circ = 0.5 * torch.sqrt(boxes[..., 3] ** 2 + boxes[..., 4] ** 2)
            worst = torch.where(valid, circ, 0.0).amax(dim=1)       # (B,)
            perm = torch.where((2.0 * worst < class_gap)[:, None], perm,
                               iota)
        inv = torch.argsort(perm, dim=1)
        boxes = torch.gather(boxes, 1, perm[..., None].expand(-1, -1, 7))
        valid = torch.gather(valid, 1, perm)
    over = overlap_matrix(boxes, iou_threshold)
    keep = nms_fixpoint(over, valid)
    return torch.gather(keep, 1, inv) if class_ids is not None else keep


def rotated_nms_pallas(boxes, scores, valid, iou_threshold: float,
                       class_ids=None, class_gap: float = 0.0):
    """One sample of :func:`rotated_nms_overlap`, with the JAX signature:
    boxes (K, 7) in descending score order, scores (K,) (unused: the order
    is positional, as in ``ops.nms.rotated_nms``), valid (K,) bool,
    class_ids (K,) int (optional, class-blocked order under the
    ``class_gap`` guard) -> keep (K,) bool. K4 on a CUDA tensor."""
    del scores
    keep = rotated_nms_overlap(
        boxes[None], valid[None], iou_threshold,
        class_ids=None if class_ids is None else class_ids[None],
        class_gap=class_gap)
    return keep[0]
