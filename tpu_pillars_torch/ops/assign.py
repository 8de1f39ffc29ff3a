"""K5 windowed target assigner + its epilogue: GT boxes -> training targets.

Port of ``tpu_pillars/ops/assign_pallas.py``. :func:`windowed_best_iou`
computes, for each sample and class, the best own-class rotated BEV IoU of
every anchor (and which GT attains it) and each GT's best anchor. On a CUDA
tensor it launches ``csrc/assign.cu`` (one thread per anchor, an exact
per-anchor circumradius gate in front of ``ops/iou.py``'s arithmetic); on a
CPU tensor it runs :func:`windowed_best_iou_plain`, the dense per-class
(Gc, Ac) IoU with the same gate and tie rules. The kernel is built without
fused multiply-adds, so the two agree to rounding.

:func:`make_windowed_assigner` wraps it with the JAX package's epilogue in
torch ops: thresholds, force-match, the single class-block -> flat unblock,
the GT pick (a ``gather``, exact as the JAX one-hot matmul at HIGHEST is)
and the residual encoding, feature-major.

Anchors far from every valid GT: the TPU kernel leaves best = -1 where its
block-level gate skipped every GT; here every valid GT is tested (gated
pairs read IoU 0), as in the dense assigner. Both values mean "negative,
no match" downstream.
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

MAX_GT_PER_CLASS = 64   # the kernel's shared-memory GT slots


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


def gt_payload(gt_c, gv_c):
    """(B, C, Gc, 7) class-grouped GT + (B, C, Gc) validity -> (B, C, Gc,
    16): corner xs, corner ys, centre, BEV area, circumradius, valid."""
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

    Anchor order is class-block (``anchor_planes``). A GT's best anchor is
    the lowest index among ties; an invalid GT reads (-1, 0)."""
    _check(gt_c, gv_c)
    if gt_c.device.type == "cpu":
        return windowed_best_iou_plain(gt_c, gv_c, config)
    B, C, Gc, _ = gt_c.shape
    if C != config.num_classes or Gc > MAX_GT_PER_CLASS:
        raise ValueError(f"windowed_best_iou: {C} classes (config has "
                         f"{config.num_classes}), {Gc} GT per class (kernel "
                         f"takes <= {MAX_GT_PER_CLASS})")
    planes = _device_planes(config, gt_c.device)
    Ac = planes.shape[2]
    pay = gt_payload(gt_c, gv_c).contiguous()
    best = torch.empty((B, C, Ac), dtype=torch.float32, device=gt_c.device)
    best_gt = torch.empty((B, C, Ac), dtype=torch.int32, device=gt_c.device)
    key = torch.zeros((B, C, Gc), dtype=torch.int64, device=gt_c.device)
    _build.launch("assign", "assign_best_iou", "pppppiiii", pay, planes, best,
                  best_gt, key, B, C, Gc, Ac)
    # key = (f32 bits | 1 << 31) << 32 | (2^32 - 1 - anchor); 0 = no valid GT
    hi = (key >> 32) & 0xFFFFFFFF
    lo = key & 0xFFFFFFFF
    val = (hi & 0x7FFFFFFF).to(torch.int32).view(torch.float32)
    empty = key == 0
    gt_val = torch.where(empty, -1.0, val)
    gt_anchor = torch.where(empty, 0, 0xFFFFFFFF - lo)
    return best, best_gt.long(), gt_val, gt_anchor


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
