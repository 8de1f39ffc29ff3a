"""GT-database sampling augmentation, numpy — copy of
``tpu_pillars/data/gt_sampler.py`` (the SECOND/PointPillars family's answer
to class imbalance: build a database of ground-truth objects with their
interior lidar points, then paste-inject samples of rare classes into
training scenes, with collision checks so injected objects never overlap
real or other injected ones).

Host-side NumPy on raw scenes, applied before the global transforms in
``data/augment.py`` (``train.data.dataset_batches`` wires both in that
order); the same ``default_rng`` draws give the JAX package's bits.

Semantics:
  * extraction: a GT box's points are all scene points inside its (slightly
    inflated by `margin`) oriented 3-D extent, stored in the box's local
    frame (so a paste at any pose is a rigid transform);
  * injection: for each class with fewer than `target_per_class` instances
    in the scene, sample stored objects (without replacement per scene) and
    place them — first try the stored pose, then random rotations of it
    about the lidar origin (keeps range/height statistics plausible);
    a placement is accepted only if its BEV rotated IoU with every current
    box (GT + previously injected) is zero;
  * background points falling inside an accepted box are removed before the
    object's points are added (they would bleed through the pasted object).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.reference_cpu.postprocess import rotated_iou_bev_np


def points_in_box(points: np.ndarray, box: np.ndarray,
                  margin: float = 0.0) -> np.ndarray:
    """Boolean mask of points inside the oriented box.

    points (n, >=3); box (7,) [x, y, z, w, l, h, yaw] with l along the
    local x (heading) axis — the canonical convention (geometry/boxes.py).
    """
    d = points[:, :3] - box[:3]
    c, s = np.cos(box[6]), np.sin(box[6])
    lx = c * d[:, 0] + s * d[:, 1]
    ly = -s * d[:, 0] + c * d[:, 1]
    return ((np.abs(lx) <= box[4] / 2 + margin)
            & (np.abs(ly) <= box[3] / 2 + margin)
            & (np.abs(d[:, 2]) <= box[5] / 2 + margin))


def points_in_boxes(points: np.ndarray, boxes: np.ndarray,
                    margin: float = 0.0) -> np.ndarray:
    """(n, >=3) x (B, 7) -> (B, n) bool membership — the batched twin of
    points_in_box, with an x-sorted slab pre-filter so each box's oriented
    test only touches points within its circumscribed radius (per-row
    results bit-identical to points_in_box: the pre-filter radius
    hypot(l/2+margin, w/2+margin) is an exact upper bound on any member's
    center distance, and the final test is the same float expression).
    The loader calls it for every scene it augments."""
    boxes = np.asarray(boxes).reshape(-1, 7)
    n, B = len(points), len(boxes)
    out = np.zeros((B, n), bool)
    if n == 0 or B == 0:
        return out
    x = np.asarray(points[:, 0], np.float64)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    rad = np.hypot(boxes[:, 4] / 2 + margin, boxes[:, 3] / 2 + margin)
    rad = rad.astype(np.float64) + 1e-4     # float-rounding slack
    lo = np.searchsorted(xs, boxes[:, 0].astype(np.float64) - rad, "left")
    hi = np.searchsorted(xs, boxes[:, 0].astype(np.float64) + rad, "right")
    for i in range(B):
        idx = order[lo[i]:hi[i]]
        if not len(idx):
            continue
        sub = points[idx]
        keep = np.abs(sub[:, 1] - boxes[i, 1]) <= rad[i]   # y slab
        idx = idx[keep]
        if not len(idx):
            continue
        sub = sub[keep]
        b = boxes[i]
        d0 = sub[:, 0] - b[0]
        d1 = sub[:, 1] - b[1]
        d2 = sub[:, 2] - b[2]
        c, s = np.cos(b[6]), np.sin(b[6])
        lx = c * d0 + s * d1
        ly = -s * d0 + c * d1
        m = ((np.abs(lx) <= b[4] / 2 + margin)
             & (np.abs(ly) <= b[3] / 2 + margin)
             & (np.abs(d2) <= b[5] / 2 + margin))
        out[i, idx[m]] = True
    return out


def _to_local(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """World-frame points -> box-local frame (extra feature cols pass)."""
    out = points.copy()
    d = points[:, :3] - box[:3]
    c, s = np.cos(box[6]), np.sin(box[6])
    out[:, 0] = c * d[:, 0] + s * d[:, 1]
    out[:, 1] = -s * d[:, 0] + c * d[:, 1]
    out[:, 2] = d[:, 2]
    return out


def _to_world(points_local: np.ndarray, box: np.ndarray) -> np.ndarray:
    out = points_local.copy()
    c, s = np.cos(box[6]), np.sin(box[6])
    out[:, 0] = c * points_local[:, 0] - s * points_local[:, 1] + box[0]
    out[:, 1] = s * points_local[:, 0] + c * points_local[:, 1] + box[1]
    out[:, 2] = points_local[:, 2] + box[2]
    return out


class GTDatabase:
    """Per-class store of (box pose+size, local-frame interior points)."""

    def __init__(self, num_classes: int):
        self.boxes: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
        self.points: List[List[np.ndarray]] = [[] for _ in range(num_classes)]

    @property
    def num_classes(self) -> int:
        return len(self.boxes)

    def counts(self) -> np.ndarray:
        return np.array([len(b) for b in self.boxes])

    def add_scene(self, points: np.ndarray, gt_boxes: np.ndarray,
                  gt_classes: np.ndarray, min_points: int = 5,
                  margin: float = 0.05) -> None:
        """Extract every GT object of the scene into the database."""
        points = np.asarray(points, np.float32)
        gt_boxes = np.asarray(gt_boxes, np.float32)
        if not len(gt_boxes):
            return
        inside_all = points_in_boxes(points, gt_boxes, margin)
        for b, c, inside in zip(gt_boxes, np.asarray(gt_classes),
                                inside_all):
            if int(inside.sum()) < min_points:
                continue
            self.boxes[int(c)].append(b.copy())
            self.points[int(c)].append(_to_local(points[inside], b))

    @classmethod
    def from_scenes(cls, scenes: Sequence, num_classes: int,
                    min_points: int = 5) -> "GTDatabase":
        db = cls(num_classes)
        for s in scenes:
            db.add_scene(s.points, s.gt_boxes, s.gt_classes,
                         min_points=min_points)
        return db

    @classmethod
    def from_dataset(cls, dataset, config: PillarsConfig,
                     tokens: Optional[Sequence[str]] = None,
                     min_points: int = 5) -> "GTDatabase":
        """Build from a LyftDataset (lidar-frame boxes + clouds)."""
        db = cls(config.num_classes)
        name_to_id = {c.name: i for i, c in enumerate(config.classes)}
        for token in (tokens or dataset.sample_tokens()):
            sd = dataset.lidar_sample_data(token)
            pts = dataset.load_point_cloud(sd)[:, : config.num_raw_features]
            boxes, classes = [], []
            for b in dataset.get_boxes_lidar(token):
                ci = name_to_id.get(b.label)
                if ci is None:
                    continue
                boxes.append(b.to_array().astype(np.float32))
                classes.append(ci)
            if boxes:
                db.add_scene(pts, np.stack(boxes), np.asarray(classes),
                             min_points=min_points)
        return db

    # --- persistence (one .npz; ragged point lists stored flat) ---

    def save(self, path: str) -> None:
        flat_boxes, flat_cls, flat_pts, offsets = [], [], [], [0]
        for ci in range(self.num_classes):
            for b, p in zip(self.boxes[ci], self.points[ci]):
                flat_boxes.append(b)
                flat_cls.append(ci)
                flat_pts.append(p)
                offsets.append(offsets[-1] + len(p))
        np.savez_compressed(
            path,
            num_classes=np.int64(self.num_classes),
            boxes=(np.stack(flat_boxes) if flat_boxes
                   else np.zeros((0, 7), np.float32)),
            classes=np.asarray(flat_cls, np.int64),
            points=(np.concatenate(flat_pts) if flat_pts
                    else np.zeros((0, 4), np.float32)),
            offsets=np.asarray(offsets, np.int64))

    @classmethod
    def load(cls, path: str) -> "GTDatabase":
        z = np.load(path)
        db = cls(int(z["num_classes"]))
        offs = z["offsets"]
        for i, (b, c) in enumerate(zip(z["boxes"], z["classes"])):
            db.boxes[int(c)].append(b.astype(np.float32))
            db.points[int(c)].append(
                z["points"][offs[i]:offs[i + 1]].astype(np.float32))
        return db


@dataclasses.dataclass(frozen=True)
class GTSampleConfig:
    target_per_class: Union[int, Mapping[int, int]] = 4
    max_attempts: int = 8       # placement tries per sampled object
    margin: float = 0.1         # metres of clearance in the removal crop


class GTSampler:
    """Callable scene augmenter: (rng, points, gt_boxes, gt_classes) ->
    augmented (points, gt_boxes, gt_classes)."""

    def __init__(self, db: GTDatabase,
                 cfg: GTSampleConfig = GTSampleConfig()):
        self.db = db
        self.cfg = cfg

    def _target(self, ci: int) -> int:
        t = self.cfg.target_per_class
        return int(t.get(ci, 0)) if isinstance(t, Mapping) else int(t)

    def __call__(self, rng: np.random.Generator, points: np.ndarray,
                 gt_boxes: np.ndarray, gt_classes: np.ndarray,
                 max_total: Optional[int] = None):
        points = np.asarray(points, np.float32)
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 7)
        gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)

        cur_boxes = list(gt_boxes)
        cur_classes = list(gt_classes)
        add_pts: List[np.ndarray] = []
        accepted_boxes: List[np.ndarray] = []

        # collision state kept as flat arrays: centers + BEV circumscribed
        # radii. A candidate whose center is farther from EVERY current box
        # than the sum of circumradii provably has zero BEV intersection,
        # so the exact rotated-IoU check runs only on near pairs. The +1e-3
        # slack makes the filter conservative against f32 rounding —
        # decisions (and therefore the augmentation stream) stay
        # bit-identical.
        cur_arr = (np.stack(cur_boxes).astype(np.float32)
                   if cur_boxes else np.zeros((0, 7), np.float32))
        cur_rad = 0.5 * np.hypot(cur_arr[:, 3], cur_arr[:, 4])

        def collides(cand: np.ndarray) -> bool:
            if not len(cur_arr):
                return False
            r = 0.5 * np.hypot(cand[3], cand[4]) + cur_rad + 1e-3
            dx = cur_arr[:, 0] - cand[0]
            dy = cur_arr[:, 1] - cand[1]
            near = dx * dx + dy * dy < r * r
            if not near.any():
                return False
            iou = rotated_iou_bev_np(cand[None], cur_arr[near])[0]
            return bool((iou > 0.0).any())

        for ci in range(self.db.num_classes):
            have = int(np.sum(gt_classes == ci))
            pool = len(self.db.boxes[ci])
            want = min(self._target(ci) - have, pool)
            if want <= 0:
                continue
            picks = rng.choice(pool, size=want, replace=False)
            for ei in picks:
                if max_total is not None and len(cur_boxes) >= max_total:
                    break
                base = self.db.boxes[ci][ei]
                for attempt in range(self.cfg.max_attempts):
                    cand = base.copy()
                    if attempt > 0:
                        # rotate the stored pose about the lidar origin:
                        # preserves range and height statistics
                        th = rng.uniform(-np.pi, np.pi)
                        c, s = np.cos(th), np.sin(th)
                        cand[0] = c * base[0] - s * base[1]
                        cand[1] = s * base[0] + c * base[1]
                        cand[6] = (base[6] + th + np.pi) % (2 * np.pi) - np.pi
                    if collides(cand):
                        continue
                    cur_boxes.append(cand)
                    cur_classes.append(ci)
                    cur_arr = np.concatenate(
                        [cur_arr, cand[None].astype(np.float32)])
                    cur_rad = np.concatenate(
                        [cur_rad, [0.5 * np.hypot(cand[3], cand[4])]])
                    add_pts.append(_to_world(self.db.points[ci][ei], cand))
                    accepted_boxes.append(cand)
                    break

        if not add_pts:
            return points, gt_boxes, gt_classes.astype(gt_classes.dtype)
        # one vectorized membership pass over all accepted boxes (the
        # per-accept points_in_box calls were the other dominant tier);
        # identical to OR-ing per-box masks
        drop = points_in_boxes(points, np.stack(accepted_boxes),
                               self.cfg.margin).any(axis=0)
        f = points.shape[1]
        pieces = [points[~drop]]
        for p in add_pts:
            if p.shape[1] < f:   # stored entries may lack e.g. a dt column
                p = np.concatenate(
                    [p, np.zeros((len(p), f - p.shape[1]), np.float32)], 1)
            pieces.append(p[:, :f])
        out_pts = np.concatenate(pieces, axis=0).astype(np.float32)
        return (out_pts, np.stack(cur_boxes).astype(np.float32),
                np.asarray(cur_classes, gt_classes.dtype))

    def inject_padded(self, rng: np.random.Generator, points: np.ndarray,
                      gb: np.ndarray, gc: np.ndarray, gv: np.ndarray):
        """Variant over padded (max_gt_boxes,) GT arrays: injected objects
        fill free slots; the static shape is the capacity cap."""
        g = int(gv.sum())
        pts, boxes, classes = self(rng, points, gb[:g], gc[:g],
                                   max_total=len(gb))
        out_gb = np.zeros_like(gb)
        out_gc = np.zeros_like(gc)
        out_gv = np.zeros_like(gv)
        n = min(len(boxes), len(gb))
        out_gb[:n] = boxes[:n]
        out_gc[:n] = classes[:n]
        out_gv[:n] = True
        return pts, out_gb, out_gc, out_gv
