"""Lyft mAP evaluation protocol, numpy — copy of
``tpu_pillars/evaluation/map_eval.py``: average precision per class by
greedy score-ordered matching on 3-D IoU, swept over the thresholds
{0.50, 0.55, ..., 0.95}, averaged over classes then thresholds (the Kaggle
competition metric of ``lyft_dataset_sdk.eval.detection.mAP_evaluation``,
re-derived with no SDK). Host-side bookkeeping over a few thousand boxes;
IoUs in float64 from ``reference_cpu.postprocess.rotated_iou_bev_np``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np

DEFAULT_IOU_THRESHOLDS: Tuple[float, ...] = tuple(
    round(0.5 + 0.05 * i, 2) for i in range(10)
)

# Protocol corners the written material does not pin (docs/MAP_PROTOCOL.md
# rows 6-7). BOTH rules are implemented in BOTH scorers so the divergence is
# measurable instead of agreed-by-fiat; the defaults are this repo's choice.
#
# match_rule:
#   "mask_argmax"  (default) — each prediction matches the highest-IoU
#                  *unmatched* GT (mask matched GTs, then argmax).
#   "argmax_check" — VOC/rafaelpadilla lineage (probably the SDK): argmax
#                  over ALL GTs including matched ones; if the single best
#                  GT is already matched the prediction is an FP even when
#                  a second unmatched GT also clears the threshold.
# tie_order (within exact score ties):
#   "stable"   (default) — input order preserved (stable sort).
#   "numpy"    — np.argsort(-scores) default introsort, the SDK's literal
#                sort call (unstable, but deterministic for a given array).
#   "reversed" — input order REVERSED within ties: the maximal deviation
#                from "stable", used to BOUND tie-order sensitivity.
MATCH_RULES = ("mask_argmax", "argmax_check")
TIE_ORDERS = ("stable", "numpy", "reversed")


def _score_order(scores: np.ndarray, tie_order: str) -> np.ndarray:
    """Descending-score visit order under the given tie rule."""
    if tie_order == "stable":
        return np.argsort(-scores, kind="stable")
    if tie_order == "numpy":
        return np.argsort(-scores)  # introsort — SDK's literal sort
    if tie_order == "reversed":
        n = len(scores)
        return n - 1 - np.argsort(-scores[::-1], kind="stable")
    raise ValueError(f"tie_order must be one of {TIE_ORDERS}: {tie_order!r}")


@dataclasses.dataclass
class EvalBox:
    sample_token: str
    class_name: str
    box: np.ndarray          # (7,) [x, y, z, w, l, h, yaw] (one common frame)
    score: float = -1.0      # -1 for ground truth

    @staticmethod
    def from_box3d(b: Box3D) -> "EvalBox":
        return EvalBox(b.token, b.label, b.to_array(), b.score)


def iou_3d_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Exact 3-D IoU (rotated BEV intersection x z overlap), float64 NumPy."""
    bev = rotated_iou_bev_np(boxes1, boxes2)
    # recover intersection area from IoU to avoid re-clipping:
    a1 = (boxes1[:, 3] * boxes1[:, 4])[:, None]
    a2 = (boxes2[:, 3] * boxes2[:, 4])[None, :]
    inter_bev = bev * (a1 + a2) / (1.0 + bev)
    z1_lo = boxes1[:, 2] - boxes1[:, 5] / 2
    z1_hi = boxes1[:, 2] + boxes1[:, 5] / 2
    z2_lo = boxes2[:, 2] - boxes2[:, 5] / 2
    z2_hi = boxes2[:, 2] + boxes2[:, 5] / 2
    z = np.maximum(
        np.minimum(z1_hi[:, None], z2_hi[None, :])
        - np.maximum(z1_lo[:, None], z2_lo[None, :]), 0.0)
    inter = inter_bev * z
    v1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    v2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    return inter / np.maximum(v1 + v2 - inter, 1e-12)


def _average_precision(tp: np.ndarray, fp: np.ndarray, n_gt: int) -> float:
    """All-point interpolated AP (precision envelope over recall)."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    # monotone precision envelope, integrate over recall
    mrec = np.concatenate([[0.0], recall, [recall[-1]]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def get_average_precisions(
    gt_boxes: Iterable[EvalBox], pred_boxes: Iterable[EvalBox],
    class_names: Sequence[str], iou_threshold: float,
    match_rule: str = "mask_argmax", tie_order: str = "stable",
) -> np.ndarray:
    """Per-class AP at one 3-D IoU threshold. NaN for classes with no GT.

    match_rule / tie_order: see MATCH_RULES / TIE_ORDERS above
    (docs/MAP_PROTOCOL.md rows 6-7)."""
    if match_rule not in MATCH_RULES:
        raise ValueError(f"match_rule must be one of {MATCH_RULES}: "
                         f"{match_rule!r}")
    gt_by: Dict[Tuple[str, str], List[EvalBox]] = defaultdict(list)
    for g in gt_boxes:
        gt_by[(g.sample_token, g.class_name)].append(g)
    preds_by_class: Dict[str, List[EvalBox]] = defaultdict(list)
    for p in pred_boxes:
        preds_by_class[p.class_name].append(p)

    aps = np.zeros((len(class_names),))
    for ci, cname in enumerate(class_names):
        n_gt = sum(len(v) for (tok, c), v in gt_by.items() if c == cname)
        cpreds = preds_by_class.get(cname, [])
        scores = np.asarray([p.score for p in cpreds], np.float64)
        preds = [cpreds[i] for i in _score_order(scores, tie_order)]
        tp = np.zeros(len(preds))
        fp = np.zeros(len(preds))
        matched: Dict[Tuple[str, str], np.ndarray] = {}
        for pi, p in enumerate(preds):
            key = (p.sample_token, cname)
            gts = gt_by.get(key, [])
            if not gts:
                fp[pi] = 1
                continue
            if key not in matched:
                matched[key] = np.zeros(len(gts), bool)
            ious = iou_3d_np(
                p.box[None], np.stack([g.box for g in gts])
            )[0]
            if match_rule == "mask_argmax":
                ious = np.where(matched[key], -1.0, ious)
                best = int(np.argmax(ious))
                hit = ious[best] >= iou_threshold
            else:  # argmax_check: best GT may already be matched -> FP
                best = int(np.argmax(ious))
                hit = (ious[best] >= iou_threshold
                       and not matched[key][best])
            if hit:
                tp[pi] = 1
                matched[key][best] = True
            else:
                fp[pi] = 1
        aps[ci] = _average_precision(tp, fp, n_gt)
    return aps


def lyft_map(
    gt_boxes: Sequence[EvalBox], pred_boxes: Sequence[EvalBox],
    class_names: Sequence[str],
    iou_thresholds: Sequence[float] = DEFAULT_IOU_THRESHOLDS,
    match_rule: str = "mask_argmax", tie_order: str = "stable",
) -> Tuple[float, Dict[float, np.ndarray]]:
    """Competition metric: mean over thresholds of the mean over classes
    (classes with no GT are excluded from the mean, SDK behavior).

    Returns (mAP, {threshold: per-class AP array}).
    """
    table: Dict[float, np.ndarray] = {}
    means = []
    for t in iou_thresholds:
        aps = get_average_precisions(gt_boxes, pred_boxes, class_names, t,
                                     match_rule=match_rule,
                                     tie_order=tie_order)
        table[t] = aps
        valid = ~np.isnan(aps)
        means.append(float(np.mean(aps[valid])) if valid.any() else 0.0)
    return float(np.mean(means)), table
