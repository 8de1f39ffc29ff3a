"""The serving comparison on hand-made sets: a near tie that greedy NMS
took in the other order is borderline and not a mismatch; a dropped, an
added or a moved detection is."""

from types import SimpleNamespace

import numpy as np
import pytest

from pillarbench import judge
from pillarbench.reference.detect import RefDetections

CONFIG = {"classes": [{"name": "car", "score_threshold": 0.1},
                      {"name": "bus", "score_threshold": 0.1}],
          "nms_iou_threshold": 0.2}
# three buses as in a served sweep: A and B overlap (IoU ~0.43) and tie
# within 1e-6; C overlaps A (IoU ~0.42) but not B; a car far away
A = [29.7024, -18.692, -0.88, 4.31, 16.22, 5.33, 1.3686]
B = [31.1253, -15.2685, -0.83, 3.64, 15.04, 4.90, 1.4663]
C = [27.8776, -19.0232, -0.83, 4.51, 17.96, 5.83, 1.2599]
CAR = [0.0, 0.0, -1.0, 1.9, 4.7, 1.7, 0.3]


def served(*dets):
    """A served answer as the loop keeps it: the arrays of its boxes."""
    boxes = [SimpleNamespace(center=np.array(b[:3]), wlh=np.array(b[3:6]),
                             yaw=b[6], score=s, label=label)
             for label, b, s in dets]
    return judge.boxes_to_arrays(boxes, ["car", "bus"])


def _arrays(dets):
    return (np.array([b for _, b, _ in dets], np.float64).reshape(-1, 7),
            np.array([s for _, _, s in dets]),
            np.array([{"car": 0, "bus": 1}[c] for c, _, _ in dets],
                     np.int64))


def ref(*dets, suppressed=()):
    """Reference detections; ``suppressed`` adds NMS candidates it did
    not keep."""
    return RefDetections(*_arrays(dets), 0.0,
                         *_arrays(list(dets) + list(suppressed)))


def compare(prog, reference):
    return judge.compare_detections({0: [prog]}, {0: reference}, CONFIG)


def test_near_tie_taken_in_the_other_order_is_borderline():
    prog = served(("car", CAR, 0.9), ("bus", A, 0.28866708))
    reference = ref(("car", CAR, 0.9), ("bus", B, 0.28866643),
                    ("bus", C, 0.2407796),
                    suppressed=[("bus", A, 0.28866650)])
    got = compare(prog, reference)
    assert got["unmatched"] == 0.0 and got["borderline"] == 3


@pytest.mark.parametrize("prog", [
    served(("car", CAR, 0.9)),                                 # dropped
    served(("car", CAR, 0.9), ("bus", B, 0.5), ("bus", A, 0.3)),  # no NMS
    served(("car", [2.0, 0, -1, 1.9, 4.7, 1.7, 0.3], 0.9),
           ("bus", B, 0.5)),                                   # moved
], ids=["dropped", "duplicate", "moved"])
def test_real_differences_count(prog):
    """A dropped detection; NMS left out (A kept under B); a box moved by
    2 m with its score: each counts."""
    reference = ref(("car", CAR, 0.9), ("bus", B, 0.5),
                    suppressed=[("bus", A, 0.3)])
    got = compare(prog, reference)
    assert got["unmatched"] > 0 and got["det_gap"] >= 0.3


def test_score_at_the_threshold_is_borderline():
    got = compare(served(("car", CAR, 0.9), ("bus", B, 0.10003)),
                  ref(("car", CAR, 0.9), suppressed=[("bus", B, 0.09998)]))
    assert got["unmatched"] == 0.0 and got["borderline"] == 1


def test_a_borderline_candidate_gap_counts():
    prog = served(("car", CAR, 0.9), ("bus", A, 0.28866708))
    reference = ref(("car", CAR, 0.9), ("bus", B, 0.28866643),
                    ("bus", C, 0.2407796),
                    suppressed=[("bus", A[:6] + [A[6] + 0.01], 0.28866650)])
    assert compare(prog, reference)["det_gap"] == pytest.approx(0.01)
