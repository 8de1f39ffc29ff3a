"""Kaggle submission writer — copy of ``tpu_pillars/data/submission.py``:
per sample one PredictionString of ``score cx cy cz w l h yaw class_name``
repeated per box (global frame), CSV columns (Id, PredictionString).
"""

from __future__ import annotations

import csv
from typing import Dict, Iterable, List

from tpu_pillars_torch.geometry.boxes import Box3D


def prediction_string(boxes: Iterable[Box3D]) -> str:
    parts: List[str] = []
    for b in boxes:
        parts.append(
            f"{b.score:.4f} {b.center[0]:.4f} {b.center[1]:.4f} "
            f"{b.center[2]:.4f} {b.wlh[0]:.4f} {b.wlh[1]:.4f} "
            f"{b.wlh[2]:.4f} {b.yaw:.4f} {b.label}"
        )
    return " ".join(parts)


def write_submission(path: str, predictions: Dict[str, List[Box3D]]) -> None:
    """predictions: sample_token -> boxes (global frame)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Id", "PredictionString"])
        for token, boxes in predictions.items():
            writer.writerow([token, prediction_string(boxes)])


def parse_prediction_string(s: str) -> List[Box3D]:
    """Inverse of prediction_string (used by tests and eval tooling)."""
    fields = s.split()
    assert len(fields) % 9 == 0, "malformed PredictionString"
    out = []
    for i in range(0, len(fields), 9):
        score, cx, cy, cz, w, l, h, yaw = map(float, fields[i : i + 8])
        out.append(Box3D(center=[cx, cy, cz], wlh=[w, l, h], yaw=yaw,
                         label=fields[i + 8], score=score))
    return out
