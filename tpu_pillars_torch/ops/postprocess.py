"""Postprocess: own-class sigmoid scores -> per-class threshold -> static
top-k -> decode + direction flip -> class-aware rotated NMS -> padded
detections. Port of ``tpu_pillars/ops/postprocess.py``, batched over a
leading B dim, in its three input layouts: :func:`postprocess_w` (the
serving wire), :func:`postprocess_t` (feature-major) and
:func:`postprocess` (anchor-major); on the same logits the three give the
same detections bit for bit.

NMS (``nms_impl``, :func:`resolve_nms_impl`): "auto" is the default
switch between the card and the CPU, as the JAX package picks per
backend: "pallas", the K4 overlap matrix, class-blocked
(``ops.nms_overlap.rotated_nms_overlap``), on a CUDA tensor, and
"fixpoint", the dense IoU of each sample's candidates
(``ops.nms.rotated_nms_batched``: ``rotated_nms`` on every sample), on the
CPU. Both keep the same sets up to IoUs within rounding of the threshold;
on the card "fixpoint" is only the check of K4, not a serving option.

Top-k ties: ``lax.top_k`` breaks ties toward the lowest index, and trained
weights saturate sigmoid scores to exactly 1.0, so ties are common. Every
selection here takes the first k of a STABLE descending sort, which has
the same rule; ``torch.topk`` has none. :func:`top_k_two_stage` is the
exact two-stage alternative, as in the JAX package not the default.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.box_coder import decode_boxes
from tpu_pillars_torch.ops.nms import rotated_nms_batched
from tpu_pillars_torch.ops.nms_overlap import rotated_nms_overlap

NMS_IMPLS = ("auto", "fixpoint", "pallas")


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


def top_k_two_stage(x, k: int, rows: int = 64):
    """Exact top-k along the last dim of (..., n) via per-row partial
    top-k: the n values cut into ``rows`` rows (the last padded with
    -inf), each row's min(k, row length) largest kept, then the k largest
    of the survivors. A row holds at most k of the global top k, so the
    first stage loses nothing. Both stages are stable sorts
    (:func:`top_k_stable`) and the survivors stay row-major, so among
    equal values the candidate order rises with the original index: ties
    go to the lowest index, ``lax.top_k``'s rule, bit for bit (as in
    :func:`top_k_stable`, -0.0 and +0.0 count as equal, where ``lax.top_k``
    puts +0.0 first; scores are never -0.0)."""
    n = x.shape[-1]
    m = -(-n // rows)
    pad = rows * m - n
    if pad:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), -math.inf)],
                      dim=-1)
    v, i = top_k_stable(x.reshape(x.shape[:-1] + (rows, m)), min(k, m))
    flat_i = (torch.arange(rows, device=x.device)[:, None] * m + i).flatten(
        -2)
    v2, sel = top_k_stable(v.flatten(-2), k)
    return v2, torch.gather(flat_i, -1, sel)


@functools.lru_cache(maxsize=None)
def _class_thresholds(thresholds: tuple, dtype, device) -> torch.Tensor:
    """The per-class score thresholds on ``device``, made once: a copy to
    the card from the host would wait for the card's queue."""
    return torch.tensor(thresholds, dtype=dtype, device=device)


def _top_candidates(own_logits, anchor_cls, config: PillarsConfig):
    """Own-class logits (B, A) -> thresholded scores, static top-K."""
    scores = torch.sigmoid(own_logits)
    thresholds = _class_thresholds(
        tuple(c.score_threshold for c in config.classes), own_logits.dtype,
        own_logits.device)[anchor_cls]
    masked = torch.where(scores >= thresholds, scores, -1.0)
    top_scores, top_idx = top_k_stable(masked, config.pre_nms_top_k)
    return top_scores, top_idx, top_scores > 0.0


def _decoded(box_rows, dir_rows, anchors, top_idx):
    """(B, K, 7) candidate residuals, (B, 2, K) direction logits -> boxes,
    direction classes."""
    return (decode_boxes(box_rows, anchors[top_idx]),
            torch.argmax(dir_rows, dim=1))


def postprocess_t(cls_t, box_t, dir_t, anchors, anchor_cls,
                  config: PillarsConfig, nms_impl: str = "auto"
                  ) -> Detections:
    """Feature-major postprocess: cls_t (B, K, A), box_t (B, 7, A), dir_t
    (B, 2, A) in canonical anchor order; anchors (A, 7) and anchor_cls (A,)
    long on the same device. The own-class logit is a per-class select."""
    own = cls_t[:, 0]
    for c in range(1, cls_t.shape[1]):
        own = torch.where(anchor_cls == c, cls_t[:, c], own)
    top_scores, top_idx, cand_valid = _top_candidates(own, anchor_cls,
                                                      config)

    def take_cols(t):                                          # (B, r, K)
        return torch.gather(t, 2, top_idx[:, None, :].expand(
            -1, t.shape[1], -1))

    boxes, dir_cls = _decoded(take_cols(box_t).transpose(1, 2),
                              take_cols(dir_t), anchors, top_idx)
    return _nms_and_pack(boxes, dir_cls, anchor_cls[top_idx], top_scores,
                         cand_valid, config, nms_impl)


def postprocess(cls_logits, box_deltas, dir_logits, anchors, anchor_cls,
                config: PillarsConfig, nms_impl: str = "auto") -> Detections:
    """Anchor-major postprocess (``models.pointpillars.ModelOutputs``):
    cls_logits (B, A, K), box_deltas (B, A, 7), dir_logits (B, A, 2);
    anchors (A, 7) and anchor_cls (A,) long on the same device."""
    B = cls_logits.shape[0]
    own = torch.gather(cls_logits, 2, anchor_cls[None, :, None].expand(
        B, -1, 1))[..., 0]
    top_scores, top_idx, cand_valid = _top_candidates(own, anchor_cls,
                                                      config)

    def take_rows(t):                                          # (B, K, r)
        return torch.gather(t, 1, top_idx[..., None].expand(
            -1, -1, t.shape[2]))

    boxes, dir_cls = _decoded(take_rows(box_deltas),
                              take_rows(dir_logits).transpose(1, 2), anchors,
                              top_idx)
    return _nms_and_pack(boxes, dir_cls, anchor_cls[top_idx], top_scores,
                         cand_valid, config, nms_impl)


def postprocess_w(own, box_p, dir_p, anchors, anchor_cls,
                  config: PillarsConfig, nms_impl: str = "auto"
                  ) -> Detections:
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

    boxes, dir_cls = _decoded(take_cols(box_p).transpose(1, 2),
                              take_cols(dir_p), anchors, top_idx)
    return _nms_and_pack(boxes, dir_cls, anchor_cls[top_idx], top_scores,
                         cand_valid, config, nms_impl)


def resolve_nms_impl(nms_impl: str, device) -> str:
    """"auto" -> "pallas" (K4) on a CUDA device, "fixpoint" on the CPU;
    "pallas" and "fixpoint" stay; any other name raises ValueError."""
    if nms_impl not in NMS_IMPLS:
        raise ValueError(f"unknown nms_impl {nms_impl!r}; expected 'auto', "
                         f"'fixpoint' or 'pallas'")
    if nms_impl == "auto":
        return "pallas" if torch.device(device).type == "cuda" \
            else "fixpoint"
    return nms_impl


def _nms_and_pack(boxes, dir_cls, cls_of, top_scores, cand_valid,
                  config: PillarsConfig, nms_impl: str) -> Detections:
    nms_impl = resolve_nms_impl(nms_impl, boxes.device)
    D = config.max_detections
    flip = (boxes[..., 6] > 0).to(dir_cls.dtype) != dir_cls
    yaw = wrap_angle(boxes[..., 6] + torch.where(flip, math.pi, 0.0))
    boxes = torch.cat([boxes[..., :6], yaw[..., None]], dim=-1)

    # class-aware NMS: translate each class into its own distant BEV region
    span = (config.x_max - config.x_min) + (config.y_max - config.y_min)
    shifted = boxes.clone()
    shifted[..., 0] = boxes[..., 0] + cls_of.to(boxes.dtype) * (4.0 * span)
    if nms_impl == "pallas":
        keep = rotated_nms_overlap(shifted, cand_valid,
                                   config.nms_iou_threshold,
                                   class_ids=cls_of, class_gap=4.0 * span)
    else:
        keep = rotated_nms_batched(shifted, cand_valid,
                                   config.nms_iou_threshold)

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
