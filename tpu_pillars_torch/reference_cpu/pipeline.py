"""CPU reference detector — copy of
``tpu_pillars/reference_cpu/pipeline.py``: the reference repo's whole
inference call stack on the host — numpy pillarize, torch-CPU forward,
numpy decode + rotated NMS -> List[Box3D].

It runs on the CPU by definition and takes no device: it is the host
baseline ``chip_smoke.py`` times and the oracle the tests hold the port's
``Detector`` against. No serving path of the card calls it; it is not a
fallback.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.ops.anchors import make_anchors
from tpu_pillars_torch.reference_cpu.model import TorchPointPillars
from tpu_pillars_torch.reference_cpu.pillarizer import pillarize_np
from tpu_pillars_torch.reference_cpu.postprocess import postprocess_np


class CPUReferenceDetector:
    """The reference pipeline on the host. The port's one entry point that
    runs on the CPU by definition, by design and not as a fallback: it
    takes no device, and no serving path of the card calls it (the tests
    and ``chip_smoke.py`` do, as oracle and as baseline)."""

    def __init__(self, config: PillarsConfig, torch_state_dict: dict | None = None):
        self.config = config
        self.model = TorchPointPillars(config)
        if torch_state_dict is not None:
            self.model.load_state_dict(torch_state_dict)
        self.model.eval()
        self.anchors, self.anchor_cls = make_anchors(config)

    @torch.no_grad()
    def predict_raw(self, points: np.ndarray):
        """points (n, F) -> (boxes (m, 7), scores (m,), class_ids (m,))."""
        feats, mask, coords, pillar_mask = pillarize_np(points, self.config)
        cls_logits, box_deltas, dir_logits = self.model(
            torch.from_numpy(feats),
            torch.from_numpy(mask),
            torch.from_numpy(coords),
            torch.from_numpy(pillar_mask),
        )
        return postprocess_np(
            cls_logits.numpy(), box_deltas.numpy(), dir_logits.numpy(),
            self.anchors, self.anchor_cls, self.config,
        )

    def predict(self, points: np.ndarray, token: str = "") -> List[Box3D]:
        boxes, scores, class_ids = self.predict_raw(points)
        names = self.config.class_names
        return [
            Box3D.from_array(b, label=names[int(c)], score=float(s), token=token)
            for b, s, c in zip(boxes, scores, class_ids)
        ]
