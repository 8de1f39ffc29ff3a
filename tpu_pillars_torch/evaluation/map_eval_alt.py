"""Independent re-implementation of the Lyft mAP protocol, numpy — copy of
``tpu_pillars/evaluation/map_eval_alt.py``, the cross-check of
``map_eval.py``: the same written definition in a deliberately different
algorithmic shape (box arrays and group indices instead of per-object
loops, per-group IoU matrices in one shot, 3-D IoU from its own
Sutherland-Hodgman clip, AP from a reversed running-max envelope).

  * AP per class at a 3-D IoU threshold: predictions by descending score
    (ties per ``tie_order``); greedy matching within the prediction's own
    (sample, class) group; each GT matches at most once; the match goes to
    the highest-IoU unmatched GT (first in GT order on IoU ties) if that
    IoU >= threshold (``match_rule`` "mask_argmax"), or to the single best
    GT only if it is unmatched ("argmax_check").
  * AP = area under the monotone precision envelope over all points,
    recall normalised by the class's total GT count.
  * Classes with no GT are left out of the per-threshold mean; mAP is the
    mean over thresholds {0.50, ..., 0.95} of those means.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from tpu_pillars_torch.evaluation.map_eval import DEFAULT_IOU_THRESHOLDS, EvalBox


def _order_desc(scores: np.ndarray, tie_order: str) -> np.ndarray:
    """Descending-score visit order — independent twin of
    map_eval._score_order (same protocol contract, written separately).

    "stable": ties keep input order. "numpy": np.argsort(-scores) introsort
    (the SDK's literal call; deterministic per array). "reversed": ties in
    REVERSED input order — the maximal deviation from stable, used to bound
    tie sensitivity (docs/MAP_PROTOCOL.md row 7)."""
    if tie_order == "stable":
        return np.argsort(-scores, kind="stable")
    if tie_order == "numpy":
        return np.argsort(-scores)
    if tie_order == "reversed":
        # stable sort on (-score, -input_index): realized by stable-sorting
        # the reversed array and mapping indices back
        return len(scores) - 1 - np.argsort(-scores[::-1], kind="stable")
    raise ValueError(f"unknown tie_order {tie_order!r}")


def _corners_bev(box: np.ndarray) -> np.ndarray:
    """(7,) [x, y, z, w, l, h, yaw] -> (4, 2) BEV corners, CCW.

    Convention (canonical spec, geometry/boxes.py): l (length) spans the
    local x (heading) axis, w the local y axis; yaw rotates local x toward
    world y.
    """
    x, y, _, w, ln, _, yaw = box[:7]
    c, s = np.cos(yaw), np.sin(yaw)
    dx = np.array([+ln, -ln, -ln, +ln]) / 2.0
    dy = np.array([+w, +w, -w, -w]) / 2.0
    return np.stack([x + c * dx - s * dy, y + s * dx + c * dy], axis=-1)


def _clip_polygon(poly: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: keep the half-plane left of directed edge a->b."""
    if len(poly) == 0:
        return poly
    d = b - a
    side = d[0] * (poly[:, 1] - a[1]) - d[1] * (poly[:, 0] - a[0])
    out: List[np.ndarray] = []
    n = len(poly)
    for i in range(n):
        j = (i + 1) % n
        pi, pj = poly[i], poly[j]
        si, sj = side[i], side[j]
        if si >= 0.0:
            out.append(pi)
        if (si >= 0.0) != (sj >= 0.0):
            t = si / (si - sj)
            out.append(pi + t * (pj - pi))
    return np.asarray(out).reshape(-1, 2)


def _poly_area(poly: np.ndarray) -> float:
    """Shoelace area of a CCW polygon."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def iou_3d_pairwise(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(P, 7) x (G, 7) -> (P, G) exact 3-D IoU, float64.

    BEV intersection by polygon clipping; volume = BEV area x z-extent
    overlap — the same geometric definition as map_eval.iou_3d_np computed
    by an unrelated algorithm.
    """
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    P, G = len(preds), len(gts)
    out = np.zeros((P, G))
    pc = [_corners_bev(p) for p in preds]
    gc = [_corners_bev(g) for g in gts]
    for i in range(P):
        vol_p = preds[i, 3] * preds[i, 4] * preds[i, 5]
        zp_lo = preds[i, 2] - preds[i, 5] / 2
        zp_hi = preds[i, 2] + preds[i, 5] / 2
        for j in range(G):
            dz = min(zp_hi, gts[j, 2] + gts[j, 5] / 2) - max(
                zp_lo, gts[j, 2] - gts[j, 5] / 2)
            if dz <= 0.0:
                continue
            poly = pc[i]
            quad = gc[j]
            for e in range(4):
                poly = _clip_polygon(poly, quad[e], quad[(e + 1) % 4])
                if len(poly) == 0:
                    break
            inter = _poly_area(poly) * dz
            if inter <= 0.0:
                continue
            vol_g = gts[j, 3] * gts[j, 4] * gts[j, 5]
            out[i, j] = inter / max(vol_p + vol_g - inter, 1e-12)
    return out


def _ap_from_matches(tp: np.ndarray, n_gt: int) -> float:
    """All-point AP from an ordered 0/1 TP vector (FP = 1 - TP)."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    ctp = np.cumsum(tp)
    ranks = np.arange(1, len(tp) + 1, dtype=np.float64)
    recall = ctp / n_gt
    precision = ctp / ranks
    envelope = np.maximum.accumulate(precision[::-1])[::-1]
    dr = np.diff(np.concatenate([[0.0], recall]))
    return float(np.dot(dr, envelope))


def get_average_precisions_alt(
    gt_boxes: Sequence[EvalBox], pred_boxes: Sequence[EvalBox],
    class_names: Sequence[str], iou_threshold: float,
    match_rule: str = "mask_argmax", tie_order: str = "stable",
) -> np.ndarray:
    """Per-class AP at one threshold — contract of
    map_eval.get_average_precisions, independent implementation.

    match_rule "mask_argmax" (default): best-IoU UNMATCHED GT wins.
    "argmax_check" (VOC lineage): argmax over ALL GTs; if the single best is
    already matched the prediction is an FP (docs/MAP_PROTOCOL.md row 6)."""
    if match_rule not in ("mask_argmax", "argmax_check"):
        raise ValueError(f"unknown match_rule {match_rule!r}")
    gt_boxes = list(gt_boxes)
    pred_boxes = list(pred_boxes)

    # group indices: (class -> token -> row indices), arrays built once
    gt_arr = (np.stack([g.box for g in gt_boxes]).astype(np.float64)
              if gt_boxes else np.zeros((0, 7)))
    gt_groups: Dict[Tuple[str, str], List[int]] = {}
    gt_count: Dict[str, int] = {c: 0 for c in class_names}
    for i, g in enumerate(gt_boxes):
        gt_groups.setdefault((g.class_name, g.sample_token), []).append(i)
        if g.class_name in gt_count:
            gt_count[g.class_name] += 1

    pred_arr = (np.stack([p.box for p in pred_boxes]).astype(np.float64)
                if pred_boxes else np.zeros((0, 7)))
    preds_by_class: Dict[str, List[int]] = {c: [] for c in class_names}
    for i, p in enumerate(pred_boxes):
        if p.class_name in preds_by_class:
            preds_by_class[p.class_name].append(i)

    aps = np.zeros(len(class_names))
    for ci, cname in enumerate(class_names):
        idxs = np.asarray(preds_by_class[cname], np.int64)
        if len(idxs):
            scores = np.asarray([pred_boxes[i].score for i in idxs])
            idxs = idxs[_order_desc(scores, tie_order)]
        tp = np.zeros(len(idxs))
        # greedy matching, one (class, token) group at a time: group state
        # is independent across groups and the within-group visit order is
        # the global (score-desc, stable) order restricted to the group
        iou_cache: Dict[str, np.ndarray] = {}
        taken: Dict[str, np.ndarray] = {}
        group_pos: Dict[str, int] = {}
        for oi, pi in enumerate(idxs):
            tok = pred_boxes[pi].sample_token
            grows = gt_groups.get((cname, tok))
            if not grows:
                continue
            if tok not in iou_cache:
                gsel = (np.asarray([pred_boxes[k].sample_token == tok
                                    for k in idxs]))
                iou_cache[tok] = iou_3d_pairwise(
                    pred_arr[idxs[gsel]], gt_arr[np.asarray(grows)])
                taken[tok] = np.zeros(len(grows), bool)
                group_pos[tok] = 0
            row = iou_cache[tok][group_pos[tok]]
            group_pos[tok] += 1
            if match_rule == "mask_argmax":
                cand = np.where(taken[tok], -np.inf, row)
                best = int(np.argmax(cand))      # IoU ties: first GT wins
                hit = cand[best] >= iou_threshold
            else:  # argmax_check
                best = int(np.argmax(row))
                hit = row[best] >= iou_threshold and not taken[tok][best]
            if hit:
                tp[oi] = 1.0
                taken[tok][best] = True
        aps[ci] = _ap_from_matches(tp, gt_count[cname])
    return aps


def lyft_map_alt(
    gt_boxes: Sequence[EvalBox], pred_boxes: Sequence[EvalBox],
    class_names: Sequence[str],
    iou_thresholds: Sequence[float] = DEFAULT_IOU_THRESHOLDS,
    match_rule: str = "mask_argmax", tie_order: str = "stable",
) -> Tuple[float, Dict[float, np.ndarray]]:
    """Contract of map_eval.lyft_map — independent implementation."""
    table: Dict[float, np.ndarray] = {}
    means = []
    for t in iou_thresholds:
        aps = get_average_precisions_alt(
            gt_boxes, pred_boxes, class_names, t,
            match_rule=match_rule, tie_order=tie_order)
        table[t] = aps
        valid = ~np.isnan(aps)
        means.append(float(np.mean(aps[valid])) if valid.any() else 0.0)
    return float(np.mean(means)), table
