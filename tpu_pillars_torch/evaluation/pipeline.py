"""Evaluation: run the detector over a dataset split, collect predictions
and GT as ``EvalBox`` lists in one common frame, score Lyft mAP — port of
``tpu_pillars/evaluation/pipeline.py``.

Sweeps go through ``Detector.predict_packed_batch`` in batches; a producer
thread (``train.prefetch.prefetch``) loads and pads the next batch while
the card runs the current one. With a ``mesh`` (``parallel.make_mesh``,
in every rank of ``parallel.launch``) each batch is split over the ranks
(``parallel.eval_dp.make_dp_packed_detector``) and every rank scores the
gathered detections.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_pillars_torch.data.lyft import LyftDataset
from tpu_pillars_torch.detector import Detector, packed_to_boxes
from tpu_pillars_torch.evaluation.map_eval import EvalBox, lyft_map
from tpu_pillars_torch.evaluation.tta import flip_points, merge_packed, \
    tta_union
from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.train.prefetch import prefetch

def _load_points(dataset: LyftDataset, tok: str, cfg, num_sweeps: int):
    sd = dataset.lidar_sample_data(tok)
    if num_sweeps > 1:
        cloud = dataset.load_sweeps(tok, num_sweeps)
        return (np.concatenate(
            [cloud[:, : cfg.num_raw_features], cloud[:, 5:6]], axis=1)
            if cfg.num_sweeps > 1 else cloud[:, : cfg.num_raw_features])
    return dataset.load_point_cloud(sd)[:, : cfg.num_raw_features]


def evaluate_dataset(
    det: Detector, dataset: LyftDataset,
    sample_tokens: Optional[Sequence[str]] = None,
    num_sweeps: int = 1, global_frame: bool = True,
    batch_size: int = 8, mesh=None,
    tta_modes: Optional[Sequence[str]] = None,
    tta_merge: str = "wbf",
    match_rule: str = "mask_argmax", tie_order: str = "stable",
) -> Tuple[float, Dict, Dict[str, List[Box3D]]]:
    """Predict every sample and score it against the dataset's GT.

    Returns (mAP, {IoU threshold: per-class AP}, {token: predicted boxes}).
    Scores in the global frame when ``global_frame`` (the competition
    protocol), else in each keyframe's lidar frame. Sweeps run in batches of
    ``batch_size`` (the last batch repeats its final sweep; the repeats are
    dropped). ``tta_modes`` (e.g. ``evaluation.tta.MODES``) runs every batch
    once per flip view and merges each sample's union per ``tta_merge``
    ("wbf" or "nms", on ``det.device``).

    mesh: a ``parallel.Mesh``, in every rank of a launched group, with
    ``det`` on the rank's device: each batch (``batch_size`` rounded up to
    a multiple of the mesh size) is split over the ranks, each runs
    ``det.model`` through ``parallel.make_dp_packed_detector`` (the f32
    default front end, as the JAX package's) on its share, the detections
    are gathered, and every rank returns the same scores."""
    cfg = det.config
    tokens = list(sample_tokens or dataset.sample_tokens())
    gt_boxes: List[EvalBox] = []
    pred_boxes: List[EvalBox] = []
    predictions: Dict[str, List[Box3D]] = {}
    modes = tuple(tta_modes) if tta_modes else ("none",)
    if mesh is not None:
        from tpu_pillars_torch.parallel.eval_dp import make_dp_packed_detector

        n_dev = mesh.devices.size
        batch_size = ((max(batch_size, n_dev) + n_dev - 1) // n_dev) * n_dev
        dp_predict = make_dp_packed_detector(cfg, mesh)

        def predict_b(pts_b, n_b):
            return dp_predict(det.model, pts_b, n_b)
    else:
        predict_b = det.predict_packed_batch

    def host_batches():
        for start in range(0, len(tokens), batch_size):
            chunk = tokens[start: start + batch_size]
            clouds = [_load_points(dataset, t, cfg, num_sweeps)
                      for t in chunk]
            per_mode = []
            for mode in modes:
                padded = [det.pad_points(
                    flip_points(c, mode) if tta_modes else c)
                    for c in clouds]
                while len(padded) < batch_size:   # repeat-pad the last batch
                    padded.append(padded[-1])
                per_mode.append(
                    (np.stack([p for p, _ in padded]),
                     np.asarray([n for _, n in padded], np.int32)))
            yield chunk, per_mode

    for chunk, per_mode in prefetch(host_batches(), size=2):
        packed_modes = [predict_b(pts_b, n_b).cpu().numpy()
                        for pts_b, n_b in per_mode]
        if tta_modes:
            packed_b = [
                merge_packed(tta_union([pm[i] for pm in packed_modes], modes),
                             cfg, method=tta_merge, num_views=len(modes),
                             device=det.device)
                for i in range(len(chunk))]
        else:
            packed_b = packed_modes[0]

        for tok, packed in zip(chunk, packed_b):
            sd = dataset.lidar_sample_data(tok)
            l2g = dataset.lidar_to_global(sd) if global_frame else None
            boxes = packed_to_boxes(packed, cfg, token=tok,
                                    lidar_to_global=l2g)
            predictions[tok] = boxes
            pred_boxes.extend(EvalBox.from_box3d(b) for b in boxes)
            gts = (dataset.get_boxes_global(tok) if global_frame
                   else dataset.get_boxes_lidar(tok))
            gt_boxes.extend(EvalBox.from_box3d(g) for g in gts)

    mAP, table = lyft_map(gt_boxes, pred_boxes, cfg.class_names,
                          match_rule=match_rule, tie_order=tie_order)
    return mAP, table, predictions


def evaluate_scenes(det: Detector, scenes, class_names=None
                    ) -> Tuple[float, Dict]:
    """Lidar-frame mAP over in-memory scenes (anything with ``.points``,
    ``.gt_boxes`` and ``.gt_classes``, e.g. ``data.synthetic.SyntheticScene``)
    — the held-out score when no dataset split is mounted."""
    class_names = list(class_names or det.config.class_names)
    gt: List[EvalBox] = []
    pred: List[EvalBox] = []
    for i, sc in enumerate(scenes):
        tok = f"scene{i}"
        pred.extend(EvalBox.from_box3d(b)
                    for b in det.predict(sc.points, token=tok))
        for b, c in zip(np.asarray(sc.gt_boxes), np.asarray(sc.gt_classes)):
            gt.append(EvalBox(tok, class_names[int(c)],
                              np.asarray(b, np.float64), -1.0))
    return lyft_map(gt, pred, class_names)
