"""The comparison that decides ``correct`` in the CenterPoint cells: the
program's answers against the reference's (``reference.centerpoint``),
with the matching and borderline rules of ``judge.compare_detections``
(its ``_match`` and ``_gap``), over nine box parameters.

* ``det_gap``: the widest gap of a matched detection's [x, y, z, w, l, h,
  yaw, vx, vy] (m, m/s; yaw in rad, wrapped) or score; a detection left
  without a partner counts as a gap of its score unless a decision within
  rounding explains it. The decisions are CenterPoint's: NMS runs per
  task (across the task's classes), and a row is cut three times, at the
  score threshold, at the top ``nms_pre`` of its task and at the
  ``nms_post``-th detection kept, so a lone detection is explained when its
  score lies within ``EPS_SCORE`` of the threshold or of its task's two
  cuts, or by an NMS decision in its task as ``judge`` explains one.
  Detections are matched one to one by class (the centre within
  ``MATCH_M``, the score within ``MATCH_SCORE``); a lone program detection
  is tested against the reference's candidates of its task.
* ``map_gap``: the widest gap between the program's dense head maps and
  the reference's on the same clouds, over the largest magnitude of the
  reference's maps.
"""

from __future__ import annotations

import numpy as np

from pillarbench.judge import EPS_IOU, EPS_SCORE, _gap, _match
from pillarbench.reference.centerpoint import box_corners_bev, iou_bev_pair


def _explained_lone(pb, ps, pt, ref, pairs, threshold, nms_iou):
    """-> (lone detections no decision within rounding explains, those it
    explains, the gaps: the explained program detections' to their
    reference candidates, the scores of the unexplained)."""
    rb, rs, rt = ref.boxes, ref.scores, ref.tasks
    lone_p = set(range(len(pb))) - {a for a, _ in pairs}
    lone_r = set(range(len(rb))) - {b for _, b in pairs}
    if not lone_p and not lone_r:
        return 0, 0, []
    cands = ref.candidates
    cb = np.concatenate([c.boxes for c in cands]).reshape(-1, 9)
    cs = np.concatenate([c.scores for c in cands])
    ct = np.concatenate([np.full(len(c.scores), t)
                         for t, c in enumerate(cands)]).astype(np.int64)
    cand = dict(_match(pb, ps, pt, cb.astype(np.float64),
                       cs.astype(np.float64), ct))
    candidates = {a for a in lone_p if a in cand}
    gaps = {a: _gap(pb[a], ps[a], cb[cand[a]], cs[cand[a]])
            for a in candidates}
    cp, cr = box_corners_bev(pb), box_corners_bev(rb)

    def near(score, t):
        cuts = (threshold, cands[t].cut, ref.post_cut[t])
        return any(c > 0 and abs(score - c) <= EPS_SCORE for c in cuts)

    def explained(box, corners, score, t, ob, ocorners, oscores, otasks,
                  oexc, usable):
        for j in np.nonzero(otasks == t)[0]:
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

    usable_p = set(range(len(pb))) - (lone_p - candidates)
    usable_r = set(range(len(rb)))
    exc_p = {a for a in candidates if near(ps[a], pt[a])}
    exc_r = {b for b in lone_r if near(rs[b], rt[b])}
    changed = True
    while changed:
        changed = False
        for a in sorted(candidates - exc_p):
            if explained(pb[a], cp[a], ps[a], pt[a], rb, cr, rs, rt, exc_r,
                         usable_r):
                exc_p.add(a)
                changed = True
        for b in sorted(lone_r - exc_r):
            if explained(rb[b], cr[b], rs[b], rt[b], pb, cp, ps, pt, exc_p,
                         usable_p):
                exc_r.add(b)
                changed = True
    border = len(exc_p) + len(exc_r)
    out = [gaps[a] for a in sorted(candidates) if a in exc_p]
    out += [float(ps[a]) for a in lone_p - exc_p]
    out += [float(rs[b]) for b in lone_r - exc_r]
    return len(lone_p) + len(lone_r) - border, border, out


def compare_center(answers: dict, reference: dict, fields: dict) -> dict:
    """``answers``: {input index: [served answers, each (boxes (n, 9),
    scores (n,), classes (n,))]}; ``reference``: {input index:
    ``reference.centerpoint.CenterDetections``}; ``fields``: the config
    file's ``config`` -> {"det_gap", "unmatched", "borderline",
    "compared", "widest"}: ``widest`` names what set ``det_gap`` (a
    parameter, "score", "lone" or "none")."""
    task_of = np.concatenate([np.full(len(t["classes"]), i)
                              for i, t in enumerate(fields["tasks"])])
    gap, lone, border, total, compared = 0.0, 0, 0, 0, 0
    widest = "none"
    for i, served in answers.items():
        ref = reference[i]
        rb = np.asarray(ref.boxes, np.float64)
        rs = np.asarray(ref.scores, np.float64)
        rc = np.asarray(ref.classes)
        for pb, ps, pc in served:
            compared += 1
            pairs = _match(pb, ps, pc, rb, rs, rc)
            n_lone, n_border, gaps = _explained_lone(
                pb, ps, task_of[pc], ref._replace(boxes=rb, scores=rs),
                pairs, fields["score_threshold"], fields["nms_iou"])
            lone += n_lone
            border += n_border
            total += len(pb) + len(rb)
            for a, b in pairs:
                g = _gap(pb[a], ps[a], rb[b], rs[b])
                if g > gap:
                    gap, widest = g, _widest(pb[a], ps[a], rb[b], rs[b])
            if gaps and max(gaps) > gap:
                gap, widest = max(gaps), "lone"
    return {"det_gap": gap, "unmatched": lone / max(total, 1),
            "borderline": border, "compared": compared, "widest": widest}


PARAMS = ("x", "y", "z", "w", "l", "h", "yaw", "vx", "vy", "score")


def _widest(p_box, p_score, r_box, r_score) -> str:
    """The name of the parameter whose gap ``_gap`` takes."""
    d = np.abs(np.append(p_box - r_box, p_score - r_score))
    d[6] = abs((p_box[6] - r_box[6] + np.pi) % (2 * np.pi) - np.pi)
    return PARAMS[int(np.argmax(d))]


def map_gap(program, reference) -> float:
    """The widest gap of two (n, C, h, w) map arrays over the largest
    magnitude of the reference's."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    return float(np.abs(program - reference).max()
                 / max(np.abs(reference).max(), 1e-30))
