"""Test-time augmentation (TTA): predict under BEV flips, map detections
back, merge — port of ``tpu_pillars/evaluation/tta.py``.

Each view is one more pass of the detector over the flipped cloud (same
static shapes). Flips are exact float negations, so the view "none"
reproduces the plain detector bit for bit. The union of the views'
detections is merged on the host:

* "nms": stable score-descending sort, then class-aware rotated NMS (the
  class-shift trick of ``ops.postprocess``) through ``ops.nms.rotated_nms``
  on an explicit device, then the top ``max_detections``;
* "wbf": weighted box fusion (Solovyev et al. 2019, adapted to rotated BEV
  boxes), numpy: overlapping same-class boxes fuse into score-weighted
  means, with a circular yaw mean that aligns pi-flipped members first and a
  score scaled down when only a minority of the views found the box.

The JAX package measured the WBF merge ahead of the NMS merge on trained
checkpoints, so the evaluation surfaces default to "wbf"; ``predict_tta``
keeps "nms" as its default (cheaper, and the only merge that guarantees no
same-class overlap above the threshold).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.detector import resolve_device
from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.ops.nms import rotated_nms
from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np

MODES = ("none", "y", "x", "xy")


def flip_points(points: np.ndarray, mode: str) -> np.ndarray:
    """points (N, >=3) -> flipped copy. 'y' mirrors across the x axis
    (y -> -y), 'x' across the y axis, 'xy' both (a 180-degree rotation)."""
    if mode not in MODES:
        raise ValueError(f"unknown TTA mode {mode!r}; expected one of {MODES}")
    out = np.array(points, dtype=np.float32, copy=True)
    if "y" in mode:
        out[:, 1] = -out[:, 1]
    if "x" in mode:
        out[:, 0] = -out[:, 0]
    return out


def unflip_boxes(boxes: np.ndarray, mode: str) -> np.ndarray:
    """Map (n, 7) boxes detected in a flipped view back to the original
    frame: the centre flips as the points did; a y-flip negates the yaw, an
    x-flip reflects it (pi - yaw); the yaw wraps to [-pi, pi)."""
    out = np.array(boxes, dtype=np.float32, copy=True)
    yaw = out[:, 6].copy()
    if "y" in mode:
        out[:, 1] = -out[:, 1]
        yaw = -yaw
    if "x" in mode:
        out[:, 0] = -out[:, 0]
        yaw = np.pi - yaw
    out[:, 6] = (yaw + np.pi) % (2 * np.pi) - np.pi
    return out


def merge_packed(union: np.ndarray, cfg: PillarsConfig,
                 method: str = "nms", num_views: int = 1,
                 device=None) -> np.ndarray:
    """Merge a (n, 10) union of packed detections (already in the original
    frame) -> (m, 10), score-descending; see the module docstring. The NMS
    merge runs ``rotated_nms`` on ``device`` (None: the card, as
    ``detector.resolve_device``); pass num_views = the number of TTA views
    for the WBF score credit."""
    if not len(union):
        return union.reshape(0, 10)
    order = np.argsort(-union[:, 7], kind="stable")
    union = union[order]
    if method == "nms":
        dev = resolve_device(device)
        span = (cfg.x_max - cfg.x_min) + (cfg.y_max - cfg.y_min)
        shifted = union[:, :7].copy()
        shifted[:, 0] += union[:, 8] * 4.0 * span
        keep = rotated_nms(
            torch.from_numpy(shifted).to(dev),
            torch.from_numpy(union[:, 7].copy()).to(dev),
            torch.ones((len(union),), dtype=torch.bool, device=dev),
            cfg.nms_iou_threshold).cpu().numpy()
        return union[keep][: cfg.max_detections]
    if method != "wbf":
        raise ValueError(f"unknown merge method {method!r}; "
                         f"expected 'nms' or 'wbf'")

    thr = cfg.nms_iou_threshold
    fused_rows: list = []        # running fused (10,) per cluster
    members: list = []           # the member rows of each cluster
    for row in union:
        hit = -1
        if fused_rows:
            fb = np.stack(fused_rows)
            same = fb[:, 8] == row[8]
            if same.any():
                iou = rotated_iou_bev_np(row[None, :7], fb[same, :7])[0]
                local = np.nonzero(iou > thr)[0]
                if len(local):
                    hit = np.nonzero(same)[0][local[0]]
        if hit < 0:
            members.append([row])
            fused_rows.append(row.copy())
            continue
        members[hit].append(row)
        mem = np.stack(members[hit])
        w = mem[:, 7] / mem[:, 7].sum()
        fused = fused_rows[hit]
        fused[:6] = w @ mem[:, :6]
        # circular yaw mean with pi-flip alignment to the cluster seed
        seed = members[hit][0][6]
        d = ((mem[:, 6] - seed + np.pi) % (2 * np.pi)) - np.pi
        d = np.where(np.abs(d) > np.pi / 2,          # direction ambiguity
                     ((d + 2 * np.pi) % (2 * np.pi)) - np.pi, d)
        fused[6] = (seed + np.arctan2(w @ np.sin(d), w @ np.cos(d))
                    + np.pi) % (2 * np.pi) - np.pi
    out = np.stack(fused_rows)
    # every cluster's score: its members' mean, scaled down when only a
    # minority of the views contributed
    for i, mem_list in enumerate(members):
        scores = np.asarray([m[7] for m in mem_list])
        out[i, 7] = (scores.mean()
                     * min(len(mem_list), num_views) / num_views)
    out = out[np.argsort(-out[:, 7], kind="stable")]
    return out[: cfg.max_detections]


def tta_union(packed_by_mode, modes: Sequence[str]) -> np.ndarray:
    """Per-mode packed outputs [(D, 10) host arrays] -> the unflipped union
    of their valid rows, in ``modes`` order (merge ties then break toward
    the earlier view)."""
    packs = []
    for packed, mode in zip(packed_by_mode, modes):
        p = np.array(packed)
        p = p[p[:, 9] > 0.5]
        if len(p):
            p[:, :7] = unflip_boxes(p[:, :7], mode)
            packs.append(p)
    if not packs:
        return np.zeros((0, 10), np.float32)
    return np.concatenate(packs, axis=0)


def predict_tta(det, points: np.ndarray, modes: Sequence[str] = MODES,
                token: str = "", merge: str = "nms") -> List[Box3D]:
    """Flip-ensembled detections for one sweep: ``det`` (a ``Detector``)
    runs each mode's flipped cloud, the boxes map back, and the union
    merges per ``merge`` ("nms" on ``det.device``, or "wbf") at the
    config's ``nms_iou_threshold``. modes=("none",) with the default merge
    gives exactly ``det.predict``."""
    cfg: PillarsConfig = det.config
    packed_by_mode = [det.predict_packed(flip_points(points, mode))
                      .cpu().numpy() for mode in modes]
    merged = merge_packed(tta_union(packed_by_mode, modes), cfg,
                          method=merge, num_views=len(modes),
                          device=det.device)
    names = cfg.class_names
    return [Box3D.from_array(row[:7], label=names[int(row[8])],
                             score=float(row[7]), token=token)
            for row in merged]
