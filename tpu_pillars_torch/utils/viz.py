"""BEV visualization: point clouds + rotated boxes -> RGB images — copy of
``tpu_pillars/utils/viz.py`` (numpy, ``struct`` and ``zlib`` only; its
images equal the JAX package's bit for bit).

Competition repos of the reference's lineage ship notebook plotting of
predictions over the lidar BEV (SURVEY.md §5 metrics row: "print/notebook
plots"); this is the rebuild's equivalent as a library module — host-side,
NumPy-only, with a stdlib PNG writer so it works in any environment the
framework itself runs in (no matplotlib/PIL dependency).

Typical use::

    from tpu_pillars_torch.utils.viz import render_scene, save_png
    img = render_scene(points, pred_boxes=dets, gt_boxes=gts, config=cfg)
    save_png("scene.png", img)

`scripts/torch_visualize.py` wraps this as a CLI over the synthetic
generator, the on-disk fixture dataset, or a real Lyft-format directory.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

# one distinguishable color per Lyft class (index = class id, matching
# PillarsConfig.class_names order); GT uses _GT_COLOR regardless of class
CLASS_COLORS: Tuple[Tuple[int, int, int], ...] = (
    (255, 99, 71),    # car — tomato
    (65, 105, 225),   # truck — royal blue
    (255, 215, 0),    # bus — gold
    (186, 85, 211),   # emergency_vehicle — orchid
    (0, 206, 209),    # other_vehicle — turquoise
    (255, 140, 0),    # motorcycle — dark orange
    (250, 128, 114),  # bicycle — salmon
    (124, 252, 0),    # pedestrian — lawn green
    (255, 105, 180),  # animal — hot pink
)
_GT_COLOR = (0, 255, 0)
_POINT_COLOR = np.asarray((200, 200, 200), np.float32)


def _extent_from(config=None, points=None, extent=None):
    """Resolve the world window (x_min, x_max, y_min, y_max)."""
    if extent is not None:
        x0, x1, y0, y1 = map(float, extent)
    elif config is not None:
        x0, x1, y0, y1 = (config.x_min, config.x_max,
                          config.y_min, config.y_max)
    elif points is not None and len(points):
        p = np.asarray(points)
        x0, x1 = float(p[:, 0].min()), float(p[:, 0].max())
        y0, y1 = float(p[:, 1].min()), float(p[:, 1].max())
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0, 1.0
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1.0
    return x0, x1, y0, y1


def _world_to_px(xy: np.ndarray, extent, size) -> np.ndarray:
    """(N, 2) world (x, y) -> (N, 2) float pixel (col, row).

    +x right, +y UP (row 0 is y_max — the conventional BEV orientation,
    not the canvas row order, which puts y_min at row 0)."""
    x0, x1, y0, y1 = extent
    h, w = size
    u = (xy[..., 0] - x0) / (x1 - x0) * (w - 1)
    v = (y1 - xy[..., 1]) / (y1 - y0) * (h - 1)
    return np.stack([u, v], axis=-1)


def bev_image(points: np.ndarray, config=None, extent=None,
              size: Tuple[int, int] = (800, 800),
              gain: float = 60.0) -> np.ndarray:
    """Accumulate a point cloud into an (H, W, 3) uint8 BEV density image.

    points: (N, >=2) — only x, y are used. Brightness is log-scaled point
    density (`gain` scales the log curve). Out-of-window points are dropped.
    """
    h, w = size
    img = np.zeros((h, w, 3), np.float32)
    points = np.asarray(points, np.float64).reshape(-1, points.shape[-1]
                                                    if np.size(points) else 2)
    ext = _extent_from(config, points, extent)
    if len(points):
        px = _world_to_px(points[:, :2], ext, size)
        ij = np.round(px).astype(np.int64)
        keep = ((ij[:, 0] >= 0) & (ij[:, 0] < w)
                & (ij[:, 1] >= 0) & (ij[:, 1] < h))
        ij = ij[keep]
        hist = np.zeros((h, w), np.float32)
        np.add.at(hist, (ij[:, 1], ij[:, 0]), 1.0)
        lum = np.clip(gain * np.log1p(hist), 0.0, 255.0)
        img += lum[:, :, None] / 255.0 * _POINT_COLOR
    return np.clip(img, 0, 255).astype(np.uint8)


def _draw_segment(img: np.ndarray, p0, p1, color, thickness: int = 1):
    """Rasterize one segment by dense sampling (vectorized; no per-pixel
    Python loop). p0/p1 are float (col, row)."""
    h, w, _ = img.shape
    n = int(np.ceil(np.hypot(p1[0] - p0[0], p1[1] - p0[1]))) + 1
    t = np.linspace(0.0, 1.0, n)
    cols = np.round(p0[0] + t * (p1[0] - p0[0])).astype(np.int64)
    rows = np.round(p0[1] + t * (p1[1] - p0[1])).astype(np.int64)
    col = np.asarray(color, np.uint8)
    r = thickness // 2
    for dr in range(-r, thickness - r):
        for dc in range(-r, thickness - r):
            rr, cc = rows + dr, cols + dc
            keep = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
            img[rr[keep], cc[keep]] = col


def draw_boxes_bev(img: np.ndarray, boxes, config=None, extent=None,
                   class_ids: Optional[Sequence[int]] = None,
                   color: Optional[Tuple[int, int, int]] = None,
                   thickness: int = 1) -> np.ndarray:
    """Draw rotated-box outlines + a heading tick onto `img` (in place).

    boxes: (N, >=7) packed [x, y, z, w, l, h, yaw] array, or a sequence of
    geometry.Box3D. Per-box colors come from `class_ids` (CLASS_COLORS
    palette) unless a fixed `color` overrides; Box3D labels resolve to class
    ids via config.class_names when available.
    """
    from tpu_pillars_torch.geometry.boxes import Box3D, box_corners_bev

    if len(boxes) == 0:
        return img
    if isinstance(boxes[0], Box3D):
        if class_ids is None and config is not None:
            names = list(config.class_names)
            class_ids = [names.index(b.label) if b.label in names else 0
                         for b in boxes]
        boxes = np.stack([b.to_array() for b in boxes])
    boxes = np.asarray(boxes, np.float64)
    ext = _extent_from(config, None, extent)
    size = img.shape[:2]
    corners = _world_to_px(box_corners_bev(boxes), ext, size)   # (N, 4, 2)
    centers = _world_to_px(boxes[:, :2], ext, size)             # (N, 2)
    front_mid = (corners[:, 0] + corners[:, 3]) / 2.0           # +x local
    for i in range(len(boxes)):
        c = (color if color is not None
             else CLASS_COLORS[(int(class_ids[i]) if class_ids is not None
                                else 0) % len(CLASS_COLORS)])
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
            _draw_segment(img, corners[i, a], corners[i, b], c, thickness)
        _draw_segment(img, centers[i], front_mid[i], c, thickness)
    return img


def render_scene(points: np.ndarray, pred_boxes=None, gt_boxes=None,
                 config=None, extent=None, size: Tuple[int, int] = (800, 800),
                 pred_class_ids: Optional[Sequence[int]] = None,
                 thickness: int = 1) -> np.ndarray:
    """One-call scene render: point density + GT (green) + predictions
    (class-colored). Returns (H, W, 3) uint8."""
    img = bev_image(points, config=config, extent=extent, size=size)
    if gt_boxes is not None and len(gt_boxes):
        draw_boxes_bev(img, gt_boxes, config=config, extent=extent,
                       color=_GT_COLOR, thickness=thickness)
    if pred_boxes is not None and len(pred_boxes):
        draw_boxes_bev(img, pred_boxes, config=config, extent=extent,
                       class_ids=pred_class_ids, thickness=thickness)
    return img


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG (stdlib zlib only)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w, _ = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
