"""Frozen configuration — the port's own copy of ``tpu_pillars.config``.

One frozen dataclass pins every static shape: BEV grid, pillar budget,
points/pillar, class count, anchors per location, top-k sizes. Field names,
order and defaults are IDENTICAL to the JAX package's copy: checkpoints
carry a fingerprint of ``repr(sorted(asdict(config).items()))``
(``weights.config_fingerprint``), and the port must reproduce it byte for
byte to load them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """Per-class anchor + matching spec (one canonical anchor per class,
    placed at two yaws — SURVEY.md section 2 'Anchor generator')."""

    name: str
    width: float   # w: extent along box-local y (left-right)
    length: float  # l: extent along box-local x (heading)
    height: float  # h: extent along z
    z_center: float  # anchor center height in lidar frame (m)
    matched_iou: float    # BEV IoU >= this  -> positive anchor
    unmatched_iou: float  # BEV IoU <  this  -> negative anchor (between: ignore)
    score_threshold: float = 0.10  # sigmoid score cut before NMS


# Lyft Level-5 9-class setup [SURVEY.md section 2: "9 Lyft classes"].
# Anchor dims are the Lyft train-set mean box sizes (public competition stats).
LYFT_CLASSES: Tuple[ClassSpec, ...] = (
    ClassSpec("car",               1.93,  4.76, 1.72, -1.07, 0.60, 0.45),
    ClassSpec("truck",             2.84, 10.24, 3.44, -0.30, 0.55, 0.40),
    ClassSpec("bus",               2.96, 12.34, 3.44, -0.08, 0.55, 0.40),
    ClassSpec("emergency_vehicle", 2.45,  6.52, 2.39, -0.88, 0.50, 0.35),
    ClassSpec("other_vehicle",     2.79,  8.20, 3.23, -0.62, 0.55, 0.40),
    ClassSpec("motorcycle",        0.96,  2.35, 1.59, -1.32, 0.35, 0.20),
    ClassSpec("bicycle",           0.63,  1.76, 1.44, -1.03, 0.35, 0.20),
    ClassSpec("pedestrian",        0.77,  0.81, 1.78, -0.91, 0.35, 0.20),
    ClassSpec("animal",            0.36,  0.73, 0.51, -1.61, 0.30, 0.15),
)

ANCHOR_YAWS: Tuple[float, ...] = (0.0, math.pi / 2.0)


@dataclasses.dataclass(frozen=True)
class PillarsConfig:
    """Everything static about the detector.

    Defaults reproduce the reference's operating point [SURVEY.md/BASELINE.json]:
    400x400 BEV grid, max 12k pillars, 9 Lyft classes, 2 yaws per class.
    """

    # --- detection range (lidar frame, metres) ---
    x_min: float = -100.0
    x_max: float = 100.0
    y_min: float = -100.0
    y_max: float = 100.0
    z_min: float = -3.0
    z_max: float = 3.0

    # --- BEV voxelization [B: "400x400 grid", "max ~12k pillars"] ---
    voxel_x: float = 0.5
    voxel_y: float = 0.5
    max_pillars: int = 12000
    max_points_per_pillar: int = 32
    max_points: int = 131072  # static per-sweep point budget (pad/crop to this)

    # --- raw point features ---
    num_raw_features: int = 4   # x, y, z, intensity
    num_sweeps: int = 1         # >1 enables the time-delta channel
    # decorated per-point dim: raw + (xc,yc,zc) offsets-to-pillar-mean
    #                              + (xp,yp) offsets-to-pillar-center [P section 2.1]
    #                              + optional dt channel for multi-sweep

    # --- model ---
    pfn_channels: int = 64
    rpn_channels: Tuple[int, int, int] = (64, 128, 256)
    rpn_layers: Tuple[int, int, int] = (4, 6, 6)
    rpn_up_channels: int = 128
    head_stride: int = 2        # anchors + head at BEV stride 2 [P section 2.2]

    # --- classes / anchors ---
    classes: Tuple[ClassSpec, ...] = LYFT_CLASSES
    anchor_yaws: Tuple[float, ...] = ANCHOR_YAWS

    # --- postprocess ---
    pre_nms_top_k: int = 1024   # boxes entering NMS (static K)
    max_detections: int = 256   # boxes returned per sweep (static)
    nms_iou_threshold: float = 0.2

    # --- training ---
    pos_weight_cls: float = 1.0
    weight_loc: float = 2.0
    weight_dir: float = 0.2
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0

    # ---------- derived static shapes ----------

    @property
    def grid_w(self) -> int:  # columns <- x
        return int(round((self.x_max - self.x_min) / self.voxel_x))

    @property
    def grid_h(self) -> int:  # rows <- y
        return int(round((self.y_max - self.y_min) / self.voxel_y))

    @property
    def feature_w(self) -> int:
        return self.grid_w // self.head_stride

    @property
    def feature_h(self) -> int:
        return self.grid_h // self.head_stride

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def anchors_per_loc(self) -> int:
        return self.num_classes * len(self.anchor_yaws)

    @property
    def num_anchors(self) -> int:
        return self.feature_h * self.feature_w * self.anchors_per_loc

    @property
    def num_input_features(self) -> int:
        """Columns of the raw point cloud the pipeline ingests: x,y,z,i
        (num_raw_features) plus the sweep-lag dt channel when multi-sweep
        accumulation is on."""
        return self.num_raw_features + (1 if self.num_sweeps > 1 else 0)

    @property
    def num_decorated_features(self) -> int:
        dt = 1 if self.num_sweeps > 1 else 0
        return self.num_raw_features + 5 + dt

    @property
    def class_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    def replace(self, **kw) -> "PillarsConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.x_max > self.x_min and self.y_max > self.y_min
        assert self.z_max > self.z_min
        assert self.voxel_x > 0 and self.voxel_y > 0
        assert self.grid_w > 0 and self.grid_h > 0
        assert self.max_pillars > 0 and self.max_points_per_pillar > 0
        assert self.grid_w % self.head_stride == 0
        assert self.grid_h % self.head_stride == 0
        # RPN downsamples by 2 three times then upsamples back to stride 2.
        assert self.grid_w % 8 == 0 and self.grid_h % 8 == 0
        assert self.pre_nms_top_k >= self.max_detections


# BASELINE config #4 operating point: multi-sweep accumulated clouds (the
# dt channel on, 2x point budget, larger pillar budget — stresses the
# binning/scatter path). 10 sweeps of ~100k in-range points can exceed even
# this budget; the loaders/pad_points then truncate first-N and COUNT it
# (utils.truncation), which is the documented policy.
def multisweep_config(num_sweeps: int = 10, **kw) -> PillarsConfig:
    base = dict(num_sweeps=num_sweeps, max_points=262144, max_pillars=20000)
    base.update(kw)
    return PillarsConfig(**base)


# BASELINE config #2 operating point: car-class-only anchors on the full
# 400x400 BEV grid — the single-class head the reference lineage tunes
# first (2 anchors/loc instead of 18: a 9x smaller postprocess/assigner
# anchor axis at identical front-end and conv cost).
def car_only_config(**kw) -> PillarsConfig:
    base = dict(classes=(ClassSpec("car", 1.93, 4.76, 1.72,
                                   -1.07, 0.60, 0.45),))
    base.update(kw)
    return PillarsConfig(**base)


# A small config for tests: tiny grid, tiny budgets -> fast CPU compiles.
def tiny_config(**kw) -> PillarsConfig:
    base = dict(
        x_min=-20.0, x_max=20.0, y_min=-20.0, y_max=20.0,
        voxel_x=0.5, voxel_y=0.5,
        max_pillars=512, max_points_per_pillar=16, max_points=4096,
        pfn_channels=32, rpn_channels=(32, 64, 128), rpn_layers=(2, 2, 2),
        rpn_up_channels=32, pre_nms_top_k=128, max_detections=64,
    )
    base.update(kw)
    return PillarsConfig(**base)
