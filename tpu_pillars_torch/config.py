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


# ---------------------------------------------------------------------------
# CenterPoint-PP (Yin, Zhou, Kraehenbuehl, arXiv:2006.11275), the port's
# second model kind: the pillar front end of PointPillars with a two-layer
# PFN, an RPN whose first block is strided down to the head's stride, and
# a centre-based head of six tasks. Its own frozen dataclass: PillarsConfig's
# fields, defaults and fingerprint stay as the JAX package has them.


@dataclasses.dataclass(frozen=True)
class CenterTask:
    """One task of the centre head: its classes and their mean (w, l, h)
    sizes in metres (nuScenes train-set means)."""

    classes: Tuple[str, ...]
    sizes: Tuple[Tuple[float, float, float], ...]


# the six nuScenes tasks of the published configuration, in its order
NUSC_TASKS: Tuple[CenterTask, ...] = (
    CenterTask(("car",), ((1.97, 4.63, 1.74),)),
    CenterTask(("truck", "construction_vehicle"),
               ((2.51, 6.93, 2.84), (2.85, 6.37, 3.19))),
    CenterTask(("bus", "trailer"), ((2.94, 10.5, 3.47), (2.90, 12.29, 3.87))),
    CenterTask(("barrier",), ((2.53, 0.50, 0.98),)),
    CenterTask(("motorcycle", "bicycle"),
               ((0.77, 2.11, 1.47), (0.60, 1.70, 1.28))),
    CenterTask(("pedestrian", "traffic_cone"),
               ((0.67, 0.73, 1.77), (0.41, 0.41, 1.07))),
)

# the regression heads of every task, (name, channels), in the published
# order; each task's heatmap (one channel a class) follows them
CENTER_HEADS: Tuple[Tuple[str, int], ...] = (
    ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    """Everything static about the CenterPoint-PP detector. The front-end
    fields carry PillarsConfig's names, so the pad, the sort, K1 and K3
    take either config. Defaults are the published nuScenes setting
    (``nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py``)."""

    # --- detection range (lidar frame, metres) and pillars ---
    x_min: float = -51.2
    x_max: float = 51.2
    y_min: float = -51.2
    y_max: float = 51.2
    z_min: float = -5.0
    z_max: float = 3.0
    voxel_x: float = 0.2
    voxel_y: float = 0.2
    max_pillars: int = 60000          # the published test budget
    max_points_per_pillar: int = 20
    max_points: int = 327680          # 10 sweeps of up to 32,768 points
    num_raw_features: int = 4         # x, y, z, intensity
    num_sweeps: int = 10              # the dt column is on

    # --- model ---
    pfn_channels: Tuple[int, ...] = (64, 64)   # layer 1 is 32 + its max
    rpn_channels: Tuple[int, int, int] = (64, 128, 256)
    rpn_layers: Tuple[int, int, int] = (4, 6, 6)   # a strided conv + 3/5/5
    rpn_up_channels: int = 128
    rpn_up_strides: Tuple[float, ...] = (0.5, 1, 2)
    out_stride: int = 4               # the head's stride over the grid
    tasks: Tuple[CenterTask, ...] = NUSC_TASKS
    head_conv: int = 64
    common_heads: Tuple[Tuple[str, int], ...] = CENTER_HEADS
    heatmap_bias: float = -2.19

    # --- decode and NMS, per task ---
    score_threshold: float = 0.1
    post_center_limit: float = 61.2   # |x|, |y| of a kept centre
    post_center_limit_z: float = 10.0  # |z| of a kept centre
    nms_pre: int = 1000
    nms_post: int = 83
    nms_iou: float = 0.2

    # ---------- derived static shapes ----------

    @property
    def grid_w(self) -> int:
        return int(round((self.x_max - self.x_min) / self.voxel_x))

    @property
    def grid_h(self) -> int:
        return int(round((self.y_max - self.y_min) / self.voxel_y))

    @property
    def feature_w(self) -> int:
        return self.grid_w // self.out_stride

    @property
    def feature_h(self) -> int:
        return self.grid_h // self.out_stride

    @property
    def num_input_features(self) -> int:
        return self.num_raw_features + (1 if self.num_sweeps > 1 else 0)

    @property
    def num_decorated_features(self) -> int:
        return self.num_input_features + 5

    @property
    def pfn_out(self) -> int:
        return self.pfn_channels[-1]

    @property
    def class_names(self) -> Tuple[str, ...]:
        return tuple(c for t in self.tasks for c in t.classes)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    @property
    def max_detections(self) -> int:
        """Detections a sweep: ``nms_post`` of each task."""
        return self.nms_post * self.num_tasks

    def validate(self) -> None:
        assert self.x_max > self.x_min and self.y_max > self.y_min
        assert self.z_max > self.z_min
        assert self.voxel_x > 0 and self.voxel_y > 0
        assert self.max_pillars > 0 and self.max_points_per_pillar > 0
        assert len(self.pfn_channels) == 2, "the PFN has two layers"
        assert self.pfn_channels[0] % 2 == 0
        assert len(self.rpn_up_strides) == len(self.rpn_channels)
        # every block's up path lands on the head's stride
        for i, s in enumerate(self.rpn_up_strides):
            assert 2 ** (i + 1) / s == self.out_stride, (i, s)
        assert self.grid_w % (2 ** len(self.rpn_channels)) == 0
        assert self.grid_h % (2 ** len(self.rpn_channels)) == 0
        assert [n for n, _ in self.common_heads] == [
            n for n, _ in CENTER_HEADS], "decode reads these heads"
        assert all(len(t.classes) == len(t.sizes) >= 1 for t in self.tasks)
        assert self.nms_pre >= self.nms_post
        assert self.feature_h * self.feature_w >= self.nms_pre


def centerpoint_pp_config(**kw) -> CenterPointConfig:
    """The published CenterPoint-PP nuScenes setting: 10 sweeps, 0.2 m
    pillars on a 512 x 512 grid, a two-layer PFN, RPN up-strides 0.5 / 1 /
    2 to a 128 x 128 head, six tasks over ten classes."""
    return CenterPointConfig(**kw)


def tiny_center_config(**kw) -> CenterPointConfig:
    """A small CenterPoint config for tests: a 64 x 64 grid at 0.2 m (the
    published pillar), small budgets and widths, every task."""
    base = dict(x_min=-6.4, x_max=6.4, y_min=-6.4, y_max=6.4,
                max_pillars=512, max_points_per_pillar=8, max_points=4096,
                pfn_channels=(16, 16), rpn_channels=(16, 32, 32),
                rpn_layers=(2, 2, 2), rpn_up_channels=16, head_conv=16,
                nms_pre=64, nms_post=12, post_center_limit=7.0)
    base.update(kw)
    return CenterPointConfig(**base)
