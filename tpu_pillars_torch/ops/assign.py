"""K5 windowed target assigner + its epilogue: GT boxes -> training targets.

Port of ``tpu_pillars/ops/assign_pallas.py``. :func:`windowed_best_iou`
computes, for each sample and class, the best own-class rotated BEV IoU of
every anchor (and which GT attains it) and each GT's best anchor. On a CUDA
tensor it makes one launch of ``csrc/assign.cu`` and runs no other torch op
than the allocation of its outputs: the kernel computes the GT payload
itself, reads each tile of the static anchor planes once for every sample,
skips a GT for a whole tile of ``TILE_ROWS`` x ``TILE_LANES`` anchors when
the tile's static circle (:func:`tile_circles`, :func:`tile_gate_plain`)
proves that no anchor of the tile can pass the per-anchor circumradius
gate, and finds each GT's best anchor with one block that walks only the
tiles its gate lets through. On a CPU tensor it runs
:func:`windowed_best_iou_plain`, the dense per-class (Gc, Ac) IoU with the
same per-anchor gate and tie rules. The kernel is built without fused
multiply-adds, so the two agree to rounding. What bounds the kernel is the
bytes of its outputs; the design notes are in the ``.cu`` header.

:func:`make_windowed_assigner` wraps it with the JAX package's epilogue in
torch ops: thresholds, force-match, the single class-block -> flat unblock,
the GT pick (a ``gather``, exact as the JAX one-hot matmul at HIGHEST is)
and the residual encoding, feature-major.

Anchors far from every valid GT: the TPU kernel leaves best = -1 where its
block-level gate skipped every GT; here an anchor of a class with a valid
GT reads 0 and the first valid slot, as in the dense assigner (a gated
pair reads IoU 0), whether or not its tile was skipped. Both values mean
"negative, no match" downstream. A valid GT with no positive IoU reads
(0.0, anchor 0) here; the TPU kernel gives it the first anchor of the
first block its gate let through, or (-1, 0) when none did.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.geometry.boxes import box_corners_bev
from tpu_pillars_torch.ops.anchors import make_anchors
from tpu_pillars_torch.ops.iou import _EPS, _half_edge_integral, corners_bev
from tpu_pillars_torch.ops.target_assigner import Targets, group_gt_by_class

MAX_GT_PER_CLASS = 64   # the kernel's GT slots (a 64-bit slot mask)
# a tile of csrc/assign.cu: TILE_ROWS feature rows (kRows) by TILE_LANES
# consecutive anchors of a row's Wf * Y, one thread per anchor
TILE_ROWS, TILE_LANES = 8, 32
# the tile gate's slack (kGateRel, kGateAbs in csrc/assign.cu): relative to
# the summed radii, plus metres; far above the f32 rounding of either gate
TILE_GATE_REL = 1e-4
TILE_GATE_ABS = 1e-3


@functools.lru_cache(maxsize=8)
def anchor_planes(config: PillarsConfig) -> np.ndarray:
    """Static per-class anchor geometry (C, 12, Ac) f32, Ac = Hf * Wf * Y in
    class-block order. Rows: 0-3 corner xs, 4-7 corner ys, 8 centre x,
    9 centre y, 10 BEV area, 11 circumradius — the JAX kernel's planes
    (corners in float64, rounded to f32), without its tile padding."""
    C = config.num_classes
    Y = len(config.anchor_yaws)
    Hf, Wf = config.feature_h, config.feature_w
    anchors, _ = make_anchors(config)
    by_class = (anchors.reshape(Hf, Wf, C, Y, 7).transpose(2, 0, 1, 3, 4)
                .reshape(C, Hf * Wf * Y, 7))
    corners = box_corners_bev(by_class.reshape(-1, 7)).astype(np.float32)
    cs = corners.reshape(C, Hf * Wf * Y, 4, 2)
    planes = np.empty((C, 12, Hf * Wf * Y), np.float32)
    for k in range(4):
        planes[:, k] = cs[..., k, 0]
        planes[:, 4 + k] = cs[..., k, 1]
    planes[:, 8] = by_class[..., 0]
    planes[:, 9] = by_class[..., 1]
    planes[:, 10] = by_class[..., 3] * by_class[..., 4]
    planes[:, 11] = 0.5 * np.sqrt(by_class[..., 3] ** 2 + by_class[..., 4] ** 2)
    planes.setflags(write=False)
    return planes


@functools.lru_cache(maxsize=8)
def _device_planes(config: PillarsConfig, device) -> torch.Tensor:
    return torch.from_numpy(np.array(anchor_planes(config))).to(device)


@functools.lru_cache(maxsize=8)
def tile_circles(config: PillarsConfig) -> np.ndarray:
    """Static (C, T, 4) f32 circle of each class's anchor tiles: centre x,
    y, a radius R, 0. A tile is ``TILE_ROWS`` feature rows by
    ``TILE_LANES`` consecutive anchors of a row's Wf * Y (class-block
    order), T = ceil(Hf / TILE_ROWS) * ceil(Wf * Y / TILE_LANES) tiles in
    row-major order. Every anchor of the tile has its f32 centre
    (``anchor_planes`` rows 8, 9) within R minus its own circumradius (row
    11) of the f32 centre: computed in float64 from the f32 planes and
    rounded up, so R holds in exact arithmetic."""
    planes = anchor_planes(config).astype(np.float64)
    C = planes.shape[0]
    Hf, L = config.feature_h, config.feature_w * len(config.anchor_yaws)
    TR, TC = -(-Hf // TILE_ROWS), -(-L // TILE_LANES)
    pad = ((0, 0), (0, TR * TILE_ROWS - Hf), (0, TC * TILE_LANES - L))

    def tiles(k):           # (C, TR * TC, TILE_ROWS * TILE_LANES)
        v = np.pad(planes[:, k].reshape(C, Hf, L), pad, mode="edge")
        return (v.reshape(C, TR, TILE_ROWS, TC, TILE_LANES)
                .transpose(0, 1, 3, 2, 4).reshape(C, TR * TC, -1))

    x, y, r = tiles(8), tiles(9), tiles(11)
    cx = (0.5 * (x.min(axis=2) + x.max(axis=2))).astype(np.float32)
    cy = (0.5 * (y.min(axis=2) + y.max(axis=2))).astype(np.float32)
    reach = np.sqrt((x - cx[..., None].astype(np.float64)) ** 2
                    + (y - cy[..., None].astype(np.float64)) ** 2) + r
    radius = reach.max(axis=2)
    r32 = radius.astype(np.float32)
    r32 = np.where(r32.astype(np.float64) < radius,
                   np.nextafter(r32, np.float32(np.inf)), r32)
    out = np.stack([cx, cy, r32, np.zeros_like(r32)], axis=-1)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=8)
def _device_circles(config: PillarsConfig, device) -> torch.Tensor:
    return torch.from_numpy(np.array(tile_circles(config))).to(device)


_KERNEL_CONSTS: dict = {}


def _kernel_consts(config: PillarsConfig, device):
    """(planes, circles, Hf, Wf * Y) of the kernel on ``device``, looked up
    by the config's identity: hashing a config costs the host several
    microseconds, and the wrapper's host time is what its caller waits on.
    An entry holds its config, so the id is not reused while it lives."""
    key = (id(config), device)
    hit = _KERNEL_CONSTS.get(key)
    if hit is None:
        if len(_KERNEL_CONSTS) >= 16:
            _KERNEL_CONSTS.clear()
        hit = (config, _device_planes(config, device),
               _device_circles(config, device), config.feature_h,
               config.feature_w * len(config.anchor_yaws))
        _KERNEL_CONSTS[key] = hit
    return hit[1:]


def tile_gate_plain(gt_c, config: PillarsConfig):
    """The kernel's block-level gate in its f32 order: gt_c (B, C, Gc, 7) ->
    (B, C, Gc, T) bool, true where the tile circle proves that the GT
    passes the per-anchor gate with no anchor of the tile."""
    circ = _device_circles(config, gt_c.device)[None, :, None]  # 1 C 1 T 4
    w, l = gt_c[..., 3:4], gt_c[..., 4:5]
    gr = 0.5 * torch.sqrt(w * w + l * l)
    dx = gt_c[..., 0:1] - circ[..., 0]
    dy = gt_c[..., 1:2] - circ[..., 1]
    lim = (circ[..., 2] + gr) * (1.0 + TILE_GATE_REL) + TILE_GATE_ABS
    return dx * dx + dy * dy > lim * lim


def gt_payload(gt_c, gv_c):
    """(B, C, Gc, 7) class-grouped GT + (B, C, Gc) validity -> (B, C, Gc,
    16): corner xs, corner ys, centre, BEV area, circumradius, valid. The
    plain version's GT rows; the kernel computes the first 12 columns
    itself with the same operations."""
    corners = corners_bev(gt_c)                              # (..., 4, 2)
    area = gt_c[..., 3] * gt_c[..., 4]
    circ = 0.5 * torch.sqrt(gt_c[..., 3] ** 2 + gt_c[..., 4] ** 2)
    pad = torch.zeros_like(gt_c[..., :3])
    return torch.cat([corners[..., 0], corners[..., 1], gt_c[..., 0:2],
                      area[..., None], circ[..., None],
                      gv_c[..., None].to(gt_c.dtype), pad], dim=-1)


def _check(gt_c, gv_c):
    if gt_c.dim() != 4 or gt_c.shape[-1] != 7 \
            or gv_c.shape != gt_c.shape[:3]:
        raise ValueError(f"windowed_best_iou wants gt_c (B, C, Gc, 7) and "
                         f"gv_c (B, C, Gc); got {tuple(gt_c.shape)}, "
                         f"{tuple(gv_c.shape)}")
    if gt_c.dtype != torch.float32 or gv_c.dtype != torch.bool:
        raise TypeError(f"windowed_best_iou wants float32 / bool, got "
                        f"{gt_c.dtype} / {gv_c.dtype}")
    if gt_c.device != gv_c.device:
        raise ValueError("gt_c and gv_c lie on different devices")


def windowed_best_iou(gt_c, gv_c, config: PillarsConfig):
    """K5. gt_c (B, C, Gc, 7) f32, gv_c (B, C, Gc) bool ->
    best_iou (B, C, Ac) f32, best_gt (B, C, Ac) int64,
    gt_best_iou (B, C, Gc) f32, gt_best_anchor (B, C, Gc) int64.

    Anchor order is class-block (``anchor_planes``). An anchor of a class
    with no valid GT reads (-1, 0), one whose valid GT all read 0 reads
    (0, the first valid slot); ties go to the first slot. A GT's best
    anchor is the lowest index among ties; an invalid slot reads (-1, 0),
    a valid GT with no positive IoU (0, 0)."""
    _check(gt_c, gv_c)
    if gt_c.device.type == "cpu":
        return windowed_best_iou_plain(gt_c, gv_c, config)
    B, C, Gc, _ = gt_c.shape
    dev = gt_c.device
    planes, circles, Hf, L = _kernel_consts(config, dev)
    if C != planes.shape[0] or not 1 <= Gc <= MAX_GT_PER_CLASS:
        raise ValueError(f"windowed_best_iou: {C} classes (config has "
                         f"{planes.shape[0]}), {Gc} GT per class (kernel "
                         f"takes 1 to {MAX_GT_PER_CLASS})")
    Ac, T = planes.shape[2], circles.shape[1]
    best = torch.empty((B, C, Ac), dtype=torch.float32, device=dev)
    best_gt = torch.empty((B, C, Ac), dtype=torch.int64, device=dev)
    gt_val = torch.empty((B, C, Gc), dtype=torch.float32, device=dev)
    gt_anchor = torch.empty((B, C, Gc), dtype=torch.int64, device=dev)
    if gt_c.stride(3) != 1:
        gt_c = gt_c.contiguous()
    # the kernel reads both through their strides: the class-grouped GT
    # are a slice of a larger buffer, and a copy would cost a launch
    _build.launch("assign", "assign_best_iou", "ppppppppiiiiiiiiiiii", gt_c,
                  gv_c, planes, circles, best, best_gt, gt_val, gt_anchor, B,
                  C, Gc, Hf, L, T, *gt_c.stride()[:3], *gv_c.stride())
    return best, best_gt, gt_val, gt_anchor


def class_iou_plain(gt_c, gv_c, config: PillarsConfig):
    """Dense own-class IoU of one sample: gt_c (C, Gc, 7), gv_c (C, Gc) ->
    (C, Gc, Ac), -1 for invalid GT slots — the kernel's arithmetic and
    gate (a pair beyond the sum of circumradii reads 0), in its order."""
    planes = _device_planes(config, gt_c.device)              # (C, 12, Ac)
    ap = planes[:, None]                                      # (C, 1, 12, Ac)
    apx = [ap[:, :, q] for q in range(4)]
    apy = [ap[:, :, 4 + q] for q in range(4)]
    g = gt_payload(gt_c, gv_c)[..., None]                     # (C, Gc, 16, 1)
    gpx = [g[:, :, q] for q in range(4)]
    gpy = [g[:, :, 4 + q] for q in range(4)]
    midx = 0.125 * (gpx[0] + gpx[1] + gpx[2] + gpx[3]
                    + apx[0] + apx[1] + apx[2] + apx[3])
    midy = 0.125 * (gpy[0] + gpy[1] + gpy[2] + gpy[3]
                    + apy[0] + apy[1] + apy[2] + apy[3])
    gcx = [x - midx for x in gpx]
    gcy = [y - midy for y in gpy]
    acx = [x - midx for x in apx]
    acy = [y - midy for y in apy]
    inter = (_half_edge_integral(gcx, gcy, acx, acy)
             + _half_edge_integral(acx, acy, gcx, gcy))
    inter = torch.clamp(inter, min=0.0)
    dx = g[:, :, 8] - ap[:, :, 8]
    dy = g[:, :, 9] - ap[:, :, 9]
    rr = g[:, :, 11] + ap[:, :, 11]
    a1, a2 = g[:, :, 10], ap[:, :, 10]
    inter = torch.minimum(inter, torch.minimum(a1, a2))
    union = torch.clamp(a1 + a2 - inter, min=_EPS)
    iou = torch.clamp(inter / union, 0.0, 1.0)
    iou = torch.where(dx * dx + dy * dy > rr * rr, 0.0, iou)
    return torch.where(gv_c[..., None], iou, -1.0)


def windowed_best_iou_plain(gt_c, gv_c, config: PillarsConfig):
    """Plain PyTorch version of :func:`windowed_best_iou`: the dense
    per-class (Gc, Ac) IoU of every pair (:func:`class_iou_plain`), one
    sample at a time, with the kernel's tie rules (first g, lowest
    anchor)."""
    _check(gt_c, gv_c)
    outs = []
    for b in range(gt_c.shape[0]):
        iou = class_iou_plain(gt_c[b], gv_c[b], config)      # (C, Gc, Ac)
        outs.append((iou.amax(dim=1), torch.argmax(iou, dim=1),
                     iou.amax(dim=2), torch.argmax(iou, dim=2)))
    return tuple(torch.stack(x) for x in zip(*outs))


class _AssignConsts:
    """Static flat-layout tensors of the epilogue on one device."""

    def __init__(self, config: PillarsConfig, max_gt_per_class: int,
                 device):
        anchors, anchor_cls = make_anchors(config)
        C = config.num_classes
        self.anchor_ch = torch.from_numpy(
            np.ascontiguousarray(anchors.T)).to(device)            # (7, A)
        cls = torch.from_numpy(np.array(anchor_cls, np.int64)).to(device)
        self.anchor_onehot = (cls[None, :] == torch.arange(
            C, device=device)[:, None]).to(torch.float32)          # (C, A)
        self.slot_base = cls * max_gt_per_class                    # (A,)
        self.matched = torch.tensor([c.matched_iou for c in config.classes],
                                    dtype=torch.float32, device=device)
        self.unmatched = torch.tensor(
            [c.unmatched_iou for c in config.classes], dtype=torch.float32,
            device=device)


@functools.lru_cache(maxsize=8)
def _consts(config: PillarsConfig, max_gt_per_class: int, device):
    return _AssignConsts(config, max_gt_per_class, device)


def make_windowed_assigner(config: PillarsConfig, max_gt_per_class: int = 16):
    """Returns assign(gt_boxes (B, G, 7), gt_cls (B, G), gt_valid (B, G)) ->
    batched feature-major :class:`Targets`, on the device of its inputs."""
    C = config.num_classes
    Y = len(config.anchor_yaws)
    HW = config.feature_h * config.feature_w
    A = config.num_anchors

    @torch.no_grad()
    def assign(gt_boxes, gt_cls, gt_valid) -> Targets:
        dev = gt_boxes.device
        k = _consts(config, max_gt_per_class, dev)
        B = gt_boxes.shape[0]
        gt_c, gv_c = group_gt_by_class(gt_boxes, gt_cls, gt_valid, C,
                                       max_gt_per_class)
        best, best_gt, gt_val, gt_anchor = windowed_best_iou(gt_c, gv_c,
                                                             config)
        Ac = best.shape[2]
        Gc = max_gt_per_class

        # force-match: each valid GT with a positive best IoU claims its
        # best anchor (scatter-max over the flat (B, C, Ac) anchor axis)
        claim = gv_c & (gt_val > 0.0)
        at = (gt_anchor + torch.arange(B * C, device=dev).reshape(B, C, 1)
              * Ac).reshape(-1)
        forced = torch.zeros(B * C * Ac, dtype=torch.int32, device=dev)
        forced.scatter_reduce_(0, at, claim.to(torch.int32).reshape(-1),
                               "amax")
        gidx = torch.arange(Gc, device=dev, dtype=torch.int32)
        forced_gt = torch.full((B * C * Ac,), -1, dtype=torch.int32,
                               device=dev)
        forced_gt.scatter_reduce_(
            0, at, torch.where(claim, gidx, -1).reshape(-1), "amax")
        forced = forced.reshape(B, C, Ac) > 0
        forced_gt = forced_gt.reshape(B, C, Ac)
        pos = (best >= k.matched[:, None]) | forced
        neg = (best < k.unmatched[:, None]) & ~pos
        assigned = torch.where(forced & (forced_gt >= 0), forced_gt.long(),
                               best_gt)
        code = assigned | (pos.long() << 8) | (neg.long() << 9)

        # the single class-block -> flat transpose of the epilogue
        code = code.reshape(B, C, HW, Y).permute(0, 2, 1, 3).reshape(B, A)
        posb = (code & (1 << 8)) != 0
        negb = (code & (1 << 9)) != 0
        posf = posb.to(torch.float32)

        # each anchor's assigned GT box, straight into (B, 7, A)
        slot = k.slot_base[None, :] + (code & 0xFF)                # (B, A)
        gtf = gt_c.reshape(B, C * Gc, 7)
        picked = torch.gather(gtf, 1, slot[..., None].expand(B, A, 7)
                              ).transpose(1, 2)                    # (B, 7, A)
        px, py, pz, pw, plen, ph, pt = picked.unbind(1)
        xa, ya, za, wa, la, ha, ta = (k.anchor_ch[i][None] for i in range(7))
        d = torch.sqrt(wa * wa + la * la)
        # encode_boxes, feature-major; padded slots hold zero boxes (log ->
        # -inf), so select under pos before anything can NaN
        reg = torch.stack([
            (px - xa) / d,
            (py - ya) / d,
            (pz - za) / ha,
            torch.log(pw / wa),
            torch.log(plen / la),
            torch.log(ph / ha),
            pt - ta,
        ], dim=1)
        reg = torch.where(posb[:, None, :], reg, 0.0)
        return Targets(
            cls_onehot=k.anchor_onehot[None] * posf[:, None, :],
            reg_targets=reg,
            dir_targets=((pt > 0.0) & posb).to(torch.int32),
            cls_weights=(posb | negb).to(torch.float32),
            reg_weights=posf,
            num_pos=posf.sum(dim=1),
        )

    return assign
