"""The comparison that decides ``correct``: the program's answers against
the reference's, as numbers, each held to its limit from the traffic
file's ``limits``.

Serving (every served answer of the sampled inputs, each against the
reference's boxes of the same cloud): ``det_gap``, the widest gap. The
detections are matched one to one (same class, centres within
``MATCH_M``, scores within ``MATCH_SCORE``); a matched pair's gap is the
widest absolute gap of any box parameter (m; yaw in rad, wrapped) or of
the score. A detection left without a partner on either side counts as a
gap of its score (a box missing or added is wrong by all of its score),
unless a decision within rounding explains it; those are counted apart
(``borderline``, with ``unmatched`` the share of the rest). A program
detection can be explained only if it is one of the reference's own NMS
candidates (matched as above; its gap to that candidate counts). Then a
detection is explained when its score lies within ``EPS_SCORE`` of its
class's threshold or of the reference's top-k cut; when it overlaps,
above the NMS threshold less ``EPS_IOU``, a detection of the other side
whose score lies within ``EPS_SCORE`` of its own (greedy NMS took the two
in the other order); when its overlap with a detection of the other side
scored no lower lies within ``EPS_IOU`` of the NMS threshold; and,
repeated until nothing changes, when an explained detection of the other
side, scored no lower, overlaps it above the threshold (the next decision
in the chain).

Training (the first steps, from the same weights on the same batches):

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the gradient of step 1 as the optimizer took it, the worst
  leaf's gap of norms, over the larger of that leaf's reference norm and
  the median leaf's;
* ``change_gap``: the same of each leaf's change over the compared steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import numpy as np

MATCH_M = 0.25
MATCH_SCORE = 0.05
EPS_SCORE = 5e-4
EPS_IOU = 5e-4


def boxes_to_arrays(boxes, class_names):
    """List of ``Box3D`` -> (boxes (n, 7) [x, y, z, w, l, h, yaw], scores
    (n,), classes (n,))."""
    index = {n: i for i, n in enumerate(class_names)}
    if not boxes:
        return np.zeros((0, 7)), np.zeros((0,)), np.zeros((0,), np.int64)
    arr = np.array([[*b.center, *b.wlh, b.yaw] for b in boxes], np.float64)
    return (arr, np.array([b.score for b in boxes], np.float64),
            np.array([index[b.label] for b in boxes], np.int64))


def _match(pb, ps, pc, rb, rs, rc):
    """One-to-one pairs by class and centre distance, nearest first."""
    pairs = []
    for c in np.union1d(pc, rc):
        pi, ri = np.nonzero(pc == c)[0], np.nonzero(rc == c)[0]
        if len(pi) == 0 or len(ri) == 0:
            continue
        d = np.hypot(pb[pi, None, 0] - rb[None, ri, 0],
                     pb[pi, None, 1] - rb[None, ri, 1])
        ok = (d < MATCH_M) & (np.abs(ps[pi, None] - rs[None, ri])
                              < MATCH_SCORE)
        cand = sorted(zip(d[ok], *np.nonzero(ok)))
        used_p, used_r = set(), set()
        for _, a, b in cand:
            if a not in used_p and b not in used_r:
                used_p.add(a)
                used_r.add(b)
                pairs.append((pi[a], ri[b]))
    return pairs


def _gap(p_box, p_score, r_box, r_score) -> float:
    d = np.abs(p_box - r_box)
    d[6] = abs((p_box[6] - r_box[6] + np.pi) % (2 * np.pi) - np.pi)
    return max(float(d.max()), abs(float(p_score - r_score)))


def _borderline(pb, ps, pc, ref, pairs, thresholds, nms_iou):
    """-> (lone detections no decision within rounding explains, those it
    explains, the gaps: the explained program detections' to their
    reference candidates, and the scores of the unexplained)."""
    from pillarbench.reference.geometry import box_corners_bev, iou_bev_pair

    rb, rs, rc = ref.boxes, ref.scores, ref.classes
    lone_p = set(range(len(pb))) - {a for a, _ in pairs}
    lone_r = set(range(len(rb))) - {b for _, b in pairs}
    if not lone_p and not lone_r:
        return 0, 0, []
    cb, cs, cc = (np.asarray(x) for x in (ref.cand_boxes, ref.cand_scores,
                                           ref.cand_classes))
    cand = dict(_match(pb, ps, pc, cb.astype(np.float64),
                       cs.astype(np.float64), cc))
    candidates = {a for a in lone_p if a in cand}
    gaps = [_gap(pb[a], ps[a], cb[cand[a]], cs[cand[a]]) for a in candidates]
    cp, cr = box_corners_bev(pb), box_corners_bev(rb)

    def near(score, c):
        return (abs(score - thresholds[c]) <= EPS_SCORE
                or (ref.cut > 0 and abs(score - ref.cut) <= EPS_SCORE))

    def explained(box, corners, score, c, ob, ocorners, oscores, oclasses,
                  oexc, usable):
        for j in np.nonzero(oclasses == c)[0]:
            if j not in usable:
                continue
            u = iou_bev_pair(box, ob[j], corners, ocorners[j])
            above = u > nms_iou - EPS_IOU
            if ((above and abs(oscores[j] - score) <= EPS_SCORE)
                    or (abs(u - nms_iou) <= EPS_IOU
                        and oscores[j] >= score - EPS_SCORE)
                    or (above and j in oexc
                        and oscores[j] >= score - EPS_SCORE)):
                return True
        return False

    # a program detection that is no candidate of the reference explains
    # nothing and is explained by nothing
    usable_p = set(range(len(pb))) - (lone_p - candidates)
    usable_r = set(range(len(rb)))
    exc_p = {a for a in candidates if near(ps[a], pc[a])}
    exc_r = {b for b in lone_r if near(rs[b], rc[b])}
    changed = True
    while changed:
        changed = False
        for a in sorted(candidates - exc_p):
            if explained(pb[a], cp[a], ps[a], pc[a], rb, cr, rs, rc, exc_r,
                         usable_r):
                exc_p.add(a)
                changed = True
        for b in sorted(lone_r - exc_r):
            if explained(rb[b], cr[b], rs[b], rc[b], pb, cp, ps, pc, exc_p,
                         usable_p):
                exc_r.add(b)
                changed = True
    borderline = len(exc_p) + len(exc_r)
    gaps = [g for a, g in zip(sorted(candidates), gaps) if a in exc_p]
    gaps += [float(ps[a]) for a in lone_p - exc_p]
    gaps += [float(rs[b]) for b in lone_r - exc_r]
    return len(lone_p) + len(lone_r) - borderline, borderline, gaps


def compare_detections(answers: dict, reference: dict, config: dict) -> dict:
    """``answers``: {input index: [served answers, each the arrays of
    :func:`boxes_to_arrays`]}; ``reference``:
    {input index: ``reference.detect.RefDetections``}; ``config``: the
    config file's ``config`` -> {"det_gap", "unmatched", "borderline",
    "compared"}."""
    thresholds = np.array([c["score_threshold"] for c in config["classes"]])
    gap, lone, border, total, compared = 0.0, 0, 0, 0, 0
    for i, served in answers.items():
        ref = reference[i]
        rb = np.asarray(ref.boxes, np.float64)
        rs = np.asarray(ref.scores, np.float64)
        rc = np.asarray(ref.classes)
        for boxes in served:
            compared += 1
            pb, ps, pc = boxes
            pairs = _match(pb, ps, pc, rb, rs, rc)
            n_lone, n_border, gaps = _borderline(
                pb, ps, pc, ref._replace(boxes=rb, scores=rs, classes=rc),
                pairs, thresholds, config["nms_iou_threshold"])
            lone += n_lone
            border += n_border
            total += len(pb) + len(rb)
            for a, b in pairs:
                gap = max(gap, _gap(pb[a], ps[a], rb[b], rs[b]))
            gap = max([gap] + gaps)
    return {"det_gap": gap, "unmatched": lone / max(total, 1),
            "borderline": border, "compared": compared}


def _leaf_gap(prog: dict, ref: dict, names) -> float:
    p = {k: float(np.linalg.norm(prog[k])) for k in names}
    r = {k: float(np.linalg.norm(ref[k])) for k in names}
    med = float(np.median(list(r.values())))
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names)


def compare_training(prog: dict, ref: dict, initial: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grad1": {name: array},
    "params": {name: array}} (numpy), ``initial``: {name: array} ->
    {"loss_gap", "grad_gap", "change_gap", "moving_leaves"}."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    if len(lp) != len(lr):
        loss_gap = float("inf")
    else:
        loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    names = sorted(ref["grad1"])
    grad_gap = _leaf_gap(prog["grad1"], ref["grad1"], names)
    gnorm = {k: float(np.linalg.norm(ref["grad1"][k])) for k in names}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k in names if gnorm[k] >= 1e-3 * med]
    dp = {k: prog["params"][k] - initial[k] for k in moving}
    dr = {k: ref["params"][k] - initial[k] for k in moving}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": _leaf_gap(dp, dr, moving),
            "moving_leaves": len(moving)}


def verdict(numbers: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}}) for every limited number; a
    number that is not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = float(numbers[name])
        checks[name] = {"value": v, "limit": limit}
        if not (np.isfinite(v) and v <= limit):
            ok = False
    return ok, checks
