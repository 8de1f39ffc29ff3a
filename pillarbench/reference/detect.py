"""The serving reference: raw sweeps in, boxes out, in plain numpy and
PyTorch. A frozen copy of the port's CPU reference (``reference_cpu``):

1. pillarize on the host: pillars by ascending id (the first
   ``max_pillars`` kept), points in input order within a pillar (the first
   ``max_points_per_pillar`` kept), decorated with the offsets to the
   pillar's mean and to its cell centre;
2. the PointPillars forward on running statistics, as ``torch.nn.functional``
   calls on the card, a batch of sweeps at a time (TF32 off unless asked
   for: the configuration states float32);
3. decode, per-class score threshold, top ``pre_nms_top_k``, direction
   flip, and greedy class-aware rotated NMS with the float64 polygon IoU,
   on the host.

Only the first ``max_points`` points of a cloud count: the detector's
documented first-N budget, applied to the cloud after the range crop.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pillarbench.reference.geometry import (
    box_corners_bev, decode_boxes, iou_bev_pair, make_anchors, wrap_angle,
)

BN_EPS = 1e-3


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuDNN convolutions and cuBLAS matmuls inside the
    block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def crop_and_budget(points: np.ndarray, cfg) -> np.ndarray:
    """The cloud the detector sees: its first ``num_input_features``
    columns, points inside the grid's x/y range plus one voxel and the z
    range, then the first ``max_points`` of them."""
    pts = np.asarray(points, np.float32)[:, :cfg.num_input_features]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    xh = cfg.x_min + (cfg.grid_w + 1) * cfg.voxel_x
    yh = cfg.y_min + (cfg.grid_h + 1) * cfg.voxel_y
    keep = ((x >= cfg.x_min) & (x < xh) & (y >= cfg.y_min) & (y < yh)
            & (z >= cfg.z_min) & (z <= cfg.z_max))
    return pts[keep][:cfg.max_points]


def pillarize(points: np.ndarray, cfg):
    """(n, F) real points -> (features (P, N, F + 5), mask (P, N), coords
    (P, 2) [row, col], pillar_mask (P,))."""
    P, N = cfg.max_pillars, cfg.max_points_per_pillar
    W, H = cfg.grid_w, cfg.grid_h
    points = np.asarray(points, np.float32)
    Fin = points.shape[1]
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    col = np.floor((x - cfg.x_min) / cfg.voxel_x).astype(np.int64)
    row = np.floor((y - cfg.y_min) / cfg.voxel_y).astype(np.int64)
    valid = ((col >= 0) & (col < W) & (row >= 0) & (row < H)
             & (z >= cfg.z_min) & (z <= cfg.z_max))
    pts = points[valid]
    pid = (row[valid] * W + col[valid]).astype(np.int64)
    order = np.argsort(pid, kind="stable")
    pid_s, pts_s = pid[order], pts[order]

    raw = np.zeros((P, N, Fin), np.float32)
    mask = np.zeros((P, N), bool)
    coords = np.zeros((P, 2), np.int32)
    pillar_mask = np.zeros((P,), bool)
    n_pts = len(pid_s)
    if n_pts:
        new_seg = np.concatenate([[True], pid_s[1:] != pid_s[:-1]])
        pillar_ord = np.cumsum(new_seg) - 1
        idx = np.arange(n_pts)
        rank = idx - np.maximum.accumulate(np.where(new_seg, idx, 0))
        keep = (rank < N) & (pillar_ord < P)
        raw[pillar_ord[keep], rank[keep]] = pts_s[keep]
        mask[pillar_ord[keep], rank[keep]] = True
        first = new_seg & (pillar_ord < P)
        coords[pillar_ord[first], 0] = pid_s[first] // W
        coords[pillar_ord[first], 1] = pid_s[first] % W
        pillar_mask[pillar_ord[first]] = True

    fmask = mask[..., None].astype(np.float32)
    count = np.maximum(fmask.sum(axis=1), 1.0)
    mean_xyz = (raw[..., :3] * fmask).sum(axis=1) / count
    off_mean = raw[..., :3] - mean_xyz[:, None, :]
    cx = cfg.x_min + (coords[:, 1].astype(np.float32) + 0.5) * cfg.voxel_x
    cy = cfg.y_min + (coords[:, 0].astype(np.float32) + 0.5) * cfg.voxel_y
    off_center = np.stack([raw[..., 0] - cx[:, None],
                           raw[..., 1] - cy[:, None]], axis=-1)
    features = np.concatenate([raw, off_mean, off_center], axis=-1) * fmask
    return features, mask, coords, pillar_mask


def torch_weights(tree: dict, cfg, device) -> dict:
    """Flax variables {'params', 'batch_stats'} (numpy) -> the reference's
    tensors on ``device``: conv kernels (out, in, kh, kw), transposed-conv
    kernels (in, out, kh, kw) (flax applies them spatially flipped), head
    kernels (out, in, 1, 1), the PFN kernel (in, out), each BatchNorm as
    (scale, bias, mean, var)."""
    p, s = tree["params"], tree["batch_stats"]

    def t(a):
        return torch.as_tensor(np.array(a, np.float32, order="C"),
                               device=device)

    def bn(pp, ss):
        return tuple(t(x) for x in (pp["scale"], pp["bias"], ss["mean"],
                                    ss["var"]))

    w = {"pfn": t(p["pfn"]["linear"]["kernel"]),
         "pfn_bn": bn(p["pfn"]["bn"], s["pfn"]["bn"])}
    for i, n in enumerate(cfg.rpn_layers):
        blk, blk_s = p["rpn"][f"block{i}"], s["rpn"][f"block{i}"]
        for j in range(n):
            w[f"conv{i}.{j}"] = t(np.transpose(blk[f"conv{j}"]["kernel"],
                                               (3, 2, 0, 1)))
            w[f"bn{i}.{j}"] = bn(blk[f"bn{j}"], blk_s[f"bn{j}"])
        k = p["rpn"][f"up{i}"]["deconv"]["kernel"][::-1, ::-1]
        w[f"up{i}"] = t(np.transpose(k, (2, 3, 0, 1)))
        w[f"upbn{i}"] = bn(p["rpn"][f"up{i}"]["bn"],
                           s["rpn"][f"up{i}"]["bn"])
    for name in ("cls", "box", "dir"):
        w[name] = t(np.transpose(p["head"][name]["kernel"], (3, 2, 0, 1)))
        w[name + "_b"] = t(p["head"][name]["bias"])
    return w


def _bn_eval(x, prm):
    scale, bias, mean, var = prm
    return F.batch_norm(x, mean, var, scale, bias, training=False,
                        eps=BN_EPS)


def rpn_features(w, canvas, cfg):
    """(B, C, H, W) canvas -> (B, 3 * up, H / 2, W / 2) on running
    statistics."""
    ups = []
    x = canvas
    for i, n in enumerate(cfg.rpn_layers):
        for j in range(n):
            x = F.conv2d(x, w[f"conv{i}.{j}"], stride=2 if j == 0 else 1,
                         padding=1)
            x = torch.relu(_bn_eval(x, w[f"bn{i}.{j}"]))
        s = 2 ** i
        ups.append(torch.relu(_bn_eval(
            F.conv_transpose2d(x, w[f"up{i}"], stride=s), w[f"upbn{i}"])))
    return torch.cat(ups, dim=1)


@torch.no_grad()
def forward(w, cfg, feats, mask, coords, pillar_mask):
    """Pillars of B sweeps on the card -> (cls (B, A, K), box (B, A, 7),
    dir (B, A, 2)), anchors in (row, col, class * yaws + yaw) order."""
    B, P, N, _ = feats.shape
    x = feats @ w["pfn"]                                      # (B, P, N, C)
    C = x.shape[-1]
    x = _bn_eval(x.reshape(-1, C), w["pfn_bn"]).reshape(B, P, N, C)
    x = torch.relu(x)
    x = torch.where(mask[..., None], x, torch.full_like(x, -1e9))
    x = x.amax(dim=2)
    x = torch.where(mask.any(dim=2, keepdim=True), x, torch.zeros_like(x))
    canvas = torch.zeros((B, C, cfg.grid_h * cfg.grid_w), dtype=x.dtype,
                         device=x.device)
    flat = coords[..., 0].long() * cfg.grid_w + coords[..., 1].long()
    for b in range(B):
        live = pillar_mask[b]
        canvas[b][:, flat[b][live]] = x[b][live].t()
    fm = rpn_features(w, canvas.reshape(B, C, cfg.grid_h, cfg.grid_w), cfg)
    a_loc = cfg.anchors_per_loc

    def head(name, k):
        out = F.conv2d(fm, w[name], w[name + "_b"])
        _, _, H, W = out.shape
        return (out.reshape(B, a_loc, k, H, W).permute(0, 3, 4, 1, 2)
                .reshape(B, -1, k))

    return head("cls", cfg.num_classes), head("box", 7), head("dir", 2)


def nms(boxes, scores, iou_threshold: float, max_out: int):
    """Greedy rotated BEV NMS in descending score order (stable), float64
    IoU; pairs whose circumcircles do not meet have IoU 0 and are not
    clipped. -> kept indices, at most ``max_out``."""
    order = np.argsort(-scores, kind="stable")
    corners = box_corners_bev(boxes)
    radius = 0.5 * np.hypot(boxes[:, 3].astype(np.float64),
                            boxes[:, 4].astype(np.float64))
    centre = boxes[:, :2].astype(np.float64)
    kept: list = []
    for i in order:
        if kept:
            k = np.asarray(kept)
            near = k[np.hypot(*(centre[k] - centre[i]).T)
                     <= radius[k] + radius[i]]
            if any(iou_bev_pair(boxes[i], boxes[j], corners[i], corners[j])
                   > iou_threshold for j in near):
                continue
        kept.append(int(i))
        if len(kept) >= max_out:
            break
    return np.asarray(kept, np.int64)


class RefDetections(NamedTuple):
    """One sweep's boxes (n, 7), scores (n,) and classes (n,); the score of
    the last candidate the top-k kept when it dropped any, else 0; and
    every candidate that entered NMS (boxes, scores, classes)."""

    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    cut: float
    cand_boxes: np.ndarray
    cand_scores: np.ndarray
    cand_classes: np.ndarray


def postprocess(cls_logits, box_deltas, dir_logits, anchors, anchor_cls, cfg):
    """One sweep's head outputs (numpy) -> :class:`RefDetections`: own-class
    sigmoid score, per-class threshold, top ``pre_nms_top_k`` (stable),
    decode, direction flip, class-aware NMS."""
    A = cls_logits.shape[0]
    own = cls_logits[np.arange(A), anchor_cls]
    scores = (1.0 / (1.0 + np.exp(-own))).astype(np.float32)
    thr = np.array([c.score_threshold for c in cfg.classes],
                   np.float32)[anchor_cls]
    cand = np.nonzero(scores >= thr)[0]
    if len(cand) == 0:
        none = (np.zeros((0, 7), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))
        return RefDetections(*none, 0.0, *none)
    top = cand[np.argsort(-scores[cand], kind="stable")][:cfg.pre_nms_top_k]
    cut = float(scores[top[-1]]) if len(cand) > len(top) else 0.0
    boxes = decode_boxes(box_deltas[top], anchors[top])
    dir_cls = np.argmax(dir_logits[top], axis=-1)
    flip = (boxes[:, 6] > 0).astype(np.int64) != dir_cls
    boxes[:, 6] = wrap_angle(boxes[:, 6] + np.where(flip, np.pi, 0.0))
    cls_of = anchor_cls[top]
    shifted = boxes.copy()
    span = (cfg.x_max - cfg.x_min) + (cfg.y_max - cfg.y_min)
    shifted[:, 0] += cls_of * 4.0 * span
    keep = nms(shifted, scores[top], cfg.nms_iou_threshold,
               cfg.max_detections)
    return RefDetections(boxes[keep], scores[top][keep], cls_of[keep], cut,
                         boxes, scores[top], cls_of)


class ReferenceDetector:
    """The reference pipeline over clouds, ``batch`` sweeps a forward, the
    model on ``device`` in float32 (``allow_tf32`` False) or, for the
    benchmark's control, TF32 (``allow_tf32`` True)."""

    def __init__(self, cfg, tree: dict, device, batch: int = 8,
                 allow_tf32: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch = batch
        self.allow_tf32 = allow_tf32
        self.w = torch_weights(tree, cfg, self.device)
        self.anchors, self.anchor_cls = make_anchors(cfg)

    def detect(self, clouds):
        """List of (n, F) clouds -> list of :class:`RefDetections`."""
        out = []
        for at in range(0, len(clouds), self.batch):
            chunk = [pillarize(crop_and_budget(c, self.cfg), self.cfg)
                     for c in clouds[at:at + self.batch]]
            t = [torch.as_tensor(np.stack(x), device=self.device)
                 for x in zip(*chunk)]
            with tf32(self.allow_tf32):
                cls, box, dirs = forward(self.w, self.cfg, *t)
            cls, box, dirs = (x.float().cpu().numpy() for x in (cls, box,
                                                                dirs))
            for b in range(len(chunk)):
                out.append(postprocess(cls[b], box[b], dirs[b], self.anchors,
                                       self.anchor_cls, self.cfg))
        return out
