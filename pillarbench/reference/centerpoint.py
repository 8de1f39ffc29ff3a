"""CenterPoint-PP in plain float32 PyTorch and numpy: raw clouds in,
boxes out. The oracle of the port's CenterPoint ``Detector``; it imports
nothing of the port (no kernel, no op, no config class) and no JAX, so
that the benchmark keeps a copy of it as it is
(``pillarbench/reference/centerpoint.py``).

It follows the published description (Yin, Zhou, Kraehenbuehl,
arXiv:2006.11275; ``configs/nusc/pp/nusc_centerpoint_pp_02voxel_two_pfn_
10sweep.py`` and ``det3d`` of github.com/tianweiy/CenterPoint):

1. pillarize on the host: the first ``num_input_features`` columns, the
   range crop, the first ``max_points`` points; pillar id floor((x -
   x_min) / voxel) in f32, correctly rounded; pillars by ascending id (the
   first ``max_pillars`` kept), points in input order (the first
   ``max_points_per_pillar`` kept); each point decorated with its offsets
   to the pillar's mean and to its cell centre (10 features);
2. the two-layer PFN (linear + BN + ReLU, the per-pillar max concatenated
   to every point, linear + BN + ReLU, the max; a pillar's padded slots
   are zero rows that take part in both maxima after their layer, as in
   the published ``PFNLayer``), the BEV canvas, the RPN
   (three blocks of a stride-2 3x3 conv and 3 / 5 / 5 more, up-strides
   0.5 / 1 / 2 to the head's stride 4) and the centre head (a shared 3x3
   conv + BN + ReLU; per task and output a 3x3 conv + BN + ReLU and a 3x3
   conv), every BN on its running statistics, eps 1e-3, on ``device`` in
   float32 with TF32 off for cuDNN and cuBLAS (on for the benchmark's
   control);
3. decode per task in torch on ``device``: sigmoid heatmap, the max over
   the task's classes, score > ``score_threshold``, centre inside the
   limit range, the top ``nms_pre`` (stable), x = ((col + reg_x) *
   out_stride) * voxel_x + x_min, z = height, (w, l, h) = exp(dim), yaw =
   atan2(sin, cos), velocity;
4. per task, greedy rotated BEV NMS on the host with the float64 polygon
   IoU, at most ``nms_post`` kept.

Departures from the published code, each as the port has it:

* the head's ``dim`` channels are (w, l, h), l along the heading, and the
  rows are [x, y, z, w, l, h, yaw] with yaw = atan2(rot[0], rot[1]) about
  +z (the published code converts nuScenes' own box convention);
* ties: the class of a cell's max is the lowest on ties, and the top-k
  keeps the lowest cell index among equal scores (the published code
  leaves both to ``torch.max`` and ``torch.topk``);
* the point budget: the first ``max_points`` points after the range crop
  (the published code has no cap).

``cfg`` is any object with the configuration's fields (``x_min`` ..
``voxel_y``, ``max_pillars``, ``max_points_per_pillar``, ``max_points``,
``num_raw_features``, ``num_sweeps``, ``rpn_layers``, ``rpn_up_strides``,
``out_stride``, ``tasks`` (each with ``classes``), ``common_heads``,
``score_threshold``, ``post_center_limit``, ``post_center_limit_z``,
``nms_pre``, ``nms_post``, ``nms_iou``); weights are the port's state-dict
names (``models.centerpoint.CenterPoint``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

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


def grid(cfg):
    """(grid_w, grid_h)."""
    return (int(round((cfg.x_max - cfg.x_min) / cfg.voxel_x)),
            int(round((cfg.y_max - cfg.y_min) / cfg.voxel_y)))


def num_input_features(cfg) -> int:
    return cfg.num_raw_features + (1 if cfg.num_sweeps > 1 else 0)


def crop_and_budget(points: np.ndarray, cfg) -> np.ndarray:
    """The cloud the detector sees: its first ``num_input_features``
    columns, points inside the grid's x/y range plus one voxel and the z
    range, then the first ``max_points`` of them."""
    W, H = grid(cfg)
    pts = np.asarray(points, np.float32)[:, :num_input_features(cfg)]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    xh = cfg.x_min + (W + 1) * cfg.voxel_x
    yh = cfg.y_min + (H + 1) * cfg.voxel_y
    keep = ((x >= cfg.x_min) & (x < xh) & (y >= cfg.y_min) & (y < yh)
            & (z >= cfg.z_min) & (z <= cfg.z_max))
    return pts[keep][:cfg.max_points]


def pillarize(points: np.ndarray, cfg):
    """(n, F) points -> (features (P, N, F + 5), mask (P, N), coords (P, 2)
    [row, col], pillar_mask (P,), occupied pillars)."""
    P, N = cfg.max_pillars, cfg.max_points_per_pillar
    W, H = grid(cfg)
    points = np.asarray(points, np.float32)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    col = np.floor((x - np.float32(cfg.x_min)) / np.float32(cfg.voxel_x)
                   ).astype(np.int64)
    row = np.floor((y - np.float32(cfg.y_min)) / np.float32(cfg.voxel_y)
                   ).astype(np.int64)
    valid = ((col >= 0) & (col < W) & (row >= 0) & (row < H)
             & (z >= cfg.z_min) & (z <= cfg.z_max))
    pts = points[valid]
    pid = (row[valid] * W + col[valid]).astype(np.int64)
    order = np.argsort(pid, kind="stable")
    pid_s, pts_s = pid[order], pts[order]

    raw = np.zeros((P, N, points.shape[1]), np.float32)
    mask = np.zeros((P, N), bool)
    coords = np.zeros((P, 2), np.int32)
    pillar_mask = np.zeros((P,), bool)
    occupied = 0
    if len(pid_s):
        new_seg = np.concatenate([[True], pid_s[1:] != pid_s[:-1]])
        occupied = int(new_seg.sum())
        ordinal = np.cumsum(new_seg) - 1
        idx = np.arange(len(pid_s))
        rank = idx - np.maximum.accumulate(np.where(new_seg, idx, 0))
        keep = (rank < N) & (ordinal < P)
        raw[ordinal[keep], rank[keep]] = pts_s[keep]
        mask[ordinal[keep], rank[keep]] = True
        first = new_seg & (ordinal < P)
        coords[ordinal[first], 0] = pid_s[first] // W
        coords[ordinal[first], 1] = pid_s[first] % W
        pillar_mask[ordinal[first]] = True

    fmask = mask[..., None].astype(np.float32)
    count = np.maximum(fmask.sum(axis=1), 1.0)
    mean_xyz = (raw[..., :3] * fmask).sum(axis=1) / count
    off_mean = raw[..., :3] - mean_xyz[:, None, :]
    cx = cfg.x_min + (coords[:, 1].astype(np.float32) + 0.5) * cfg.voxel_x
    cy = cfg.y_min + (coords[:, 0].astype(np.float32) + 0.5) * cfg.voxel_y
    off_center = np.stack([raw[..., 0] - cx[:, None],
                           raw[..., 1] - cy[:, None]], axis=-1)
    features = np.concatenate([raw, off_mean, off_center], axis=-1) * fmask
    return (features.astype(np.float32), mask, coords, pillar_mask,
            occupied)


_CALIBRATING = []     # a generator while :func:`calibrate` runs


def _bn(x, w, prefix):
    if _CALIBRATING:
        _set_moments(x, w, prefix, _CALIBRATING[0])
    return F.batch_norm(x, w[prefix + ".running_mean"],
                        w[prefix + ".running_var"], w[prefix + ".weight"],
                        w[prefix + ".bias"], training=False, eps=BN_EPS)


def _bn_last(x, w, prefix):
    """BatchNorm over the last axis."""
    shape = x.shape
    return _bn(x.reshape(-1, shape[-1]), w, prefix).reshape(shape)


def pfn(w, feats, mask):
    """(B, P, N, D) decorated features, (B, P, N) mask -> (B, P, C2). The
    padded slots are zeroed and run through both layers, so that each max
    takes them in, as the published ``PFNLayer`` does; an empty pillar
    gives 0."""
    x = torch.where(mask[..., None], feats, torch.zeros_like(feats))
    h = torch.relu(_bn_last(x @ w["pfn.w1"], w, "pfn.bn1"))
    m = h.amax(dim=2, keepdim=True)
    y = torch.cat([h, m.expand_as(h)], dim=-1) @ w["pfn.w2"]
    y = torch.relu(_bn_last(y, w, "pfn.bn2")).amax(dim=2)
    return torch.where(mask.any(dim=2, keepdim=True), y,
                       torch.zeros_like(y))


def rpn(w, x, cfg):
    """(B, C, H, W) canvas -> (B, 3 * up, H / 4, W / 4)."""
    ups = []
    for i, n in enumerate(cfg.rpn_layers):
        for j in range(n):
            x = F.conv2d(x, w[f"rpn.blocks.{i}.convs.{j}"],
                         stride=2 if j == 0 else 1, padding=1)
            x = torch.relu(_bn(x, w, f"rpn.blocks.{i}.bns.{j}"))
        s = cfg.rpn_up_strides[i]
        k = w[f"rpn.ups.{i}.weight"]
        if s >= 1:
            u = F.conv_transpose2d(x, k, stride=int(round(s)))
        else:
            u = F.conv2d(x, k, stride=int(round(1 / s)))
        ups.append(torch.relu(_bn(u, w, f"rpn.ups.{i}.bn")))
    return torch.cat(ups, dim=1)


def heads(cfg, task: int):
    return list(cfg.common_heads) + [("hm", len(cfg.tasks[task].classes))]


def head(w, x, cfg):
    """Features -> the dense maps, task after task, each [reg, height,
    dim, rot, vel, hm]."""
    x = F.conv2d(x, w["head.shared_w"], w["head.shared_b"], padding=1)
    x = torch.relu(_bn(x, w, "head.shared_bn"))
    outs = []
    for t in range(len(cfg.tasks)):
        for name, _ in heads(cfg, t):
            p = f"head.tasks.{t}.{name}"
            y = F.conv2d(x, w[p + ".w1"], w[p + ".b1"], padding=1)
            y = torch.relu(_bn(y, w, p + ".bn"))
            outs.append(F.conv2d(y, w[p + ".w2"], w[p + ".b2"], padding=1))
    return torch.cat(outs, dim=1)


@torch.no_grad()
def forward(w, cfg, feats, mask, coords, pillar_mask):
    """Pillars of B clouds on the weights' device -> dense maps (B, C,
    H / 4, W / 4)."""
    x = pfn(w, feats, mask)
    B, P, C = x.shape
    W, H = grid(cfg)
    canvas = torch.zeros((B, C, H * W), dtype=x.dtype, device=x.device)
    flat = coords[..., 0].long() * W + coords[..., 1].long()
    for b in range(B):
        live = pillar_mask[b]
        canvas[b][:, flat[b][live]] = x[b][live].t()
    return head(w, rpn(w, canvas.reshape(B, C, H, W), cfg), cfg)


def box_corners_bev(boxes) -> np.ndarray:
    """(N, >=7) -> (N, 4, 2) BEV corners in float64, counter-clockwise from
    the front-left (local (+l/2, +w/2))."""
    boxes = np.asarray(boxes, np.float64)
    x, y = boxes[:, 0], boxes[:, 1]
    w, l, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    lx = np.stack([l / 2, -l / 2, -l / 2, l / 2], axis=-1)
    ly = np.stack([w / 2, w / 2, -w / 2, -w / 2], axis=-1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    return np.stack([x[:, None] + c * lx - s * ly,
                     y[:, None] + s * lx + c * ly], axis=-1)


def _clip_poly(subject, clipper):
    """Sutherland-Hodgman: clip polygon ``subject`` by the convex CCW
    ``clipper``."""
    out = subject
    m = len(clipper)
    for i in range(m):
        if len(out) == 0:
            break
        a, b = clipper[i], clipper[(i + 1) % m]
        ex, ey = b[0] - a[0], b[1] - a[1]
        inp = out
        side = ex * (inp[:, 1] - a[1]) - ey * (inp[:, 0] - a[0])
        inside = side >= -1e-12
        pieces = []
        k = len(inp)
        for j in range(k):
            cur, nxt = inp[j], inp[(j + 1) % k]
            if inside[j]:
                pieces.append(cur)
            if inside[j] != inside[(j + 1) % k]:
                r = nxt - cur
                s = b - a
                denom = r[0] * s[1] - r[1] * s[0]
                t = ((a[0] - cur[0]) * s[1] - (a[1] - cur[1]) * s[0]) / denom
                pieces.append(cur + t * r)
        out = np.array(pieces) if pieces else np.zeros((0, 2))
    return out


def _poly_area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def iou_bev_pair(box_a, box_b, corners_a, corners_b) -> float:
    """Exact rotated BEV IoU of two boxes, float64 polygon clipping."""
    inter = _poly_area(_clip_poly(corners_a, corners_b))
    a1 = float(box_a[3]) * float(box_a[4])
    a2 = float(box_b[3]) * float(box_b[4])
    inter = min(inter, a1, a2)
    return inter / max(a1 + a2 - inter, 1e-12)


def nms(boxes, iou_threshold: float, max_out: int):
    """Greedy rotated BEV NMS over boxes already in score order, float64
    IoU; pairs whose circumcircles do not meet have IoU 0. -> kept
    indices, at most ``max_out``."""
    corners = box_corners_bev(boxes)
    radius = 0.5 * np.hypot(boxes[:, 3].astype(np.float64),
                            boxes[:, 4].astype(np.float64))
    centre = boxes[:, :2].astype(np.float64)
    kept: list = []
    for i in range(len(boxes)):
        if kept:
            k = np.asarray(kept)
            near = k[np.hypot(*(centre[k] - centre[i]).T)
                     <= radius[k] + radius[i]]
            if any(iou_bev_pair(boxes[i], boxes[j], corners[i], corners[j])
                   > iou_threshold for j in near):
                continue
        kept.append(i)
        if len(kept) >= max_out:
            break
    return np.asarray(kept, np.int64)


def _set_moments(x, w, prefix, gen):
    """A BatchNorm's running statistics from its input's moments over the
    calibration batch, each channel's then moved by a draw: the variance
    times exp(U(-0.25, 0.25)), the mean plus 0.1 N(0, 1) standard
    deviations."""
    dims = [d for d in range(x.dim()) if d != 1]
    mean = x.mean(dim=dims)
    var = x.var(dim=dims, unbiased=False)
    c = mean.shape[0]
    u = torch.rand(c, generator=gen, device=x.device) * 0.5 - 0.25
    n = torch.randn(c, generator=gen, device=x.device)
    w[prefix + ".running_var"] = (var * torch.exp(u)).clamp(min=1e-4)
    w[prefix + ".running_mean"] = mean + 0.1 * torch.sqrt(var) * n


@torch.no_grad()
def calibrate(w: dict, cfg, clouds, gen: torch.Generator) -> dict:
    """The weights ``w`` with every BatchNorm's running statistics set from
    the moments of its input over ``clouds`` (one forward, layer by layer
    in order), each moved by a draw from ``gen`` (:func:`_set_moments`),
    so that no BatchNorm is the identity and every layer's output keeps
    the scale its affine gives it. Returns the new dict."""
    w = dict(w)
    dev = next(iter(w.values())).device
    chunk = [pillarize(crop_and_budget(c, cfg), cfg) for c in clouds]
    t = [torch.as_tensor(np.stack(x), device=dev)
         for x in list(zip(*chunk))[:4]]
    _CALIBRATING.append(gen)
    try:
        with tf32(False):
            forward(w, cfg, *t)
    finally:
        _CALIBRATING.clear()
    return w


class Candidates(NamedTuple):
    """One (cloud, task)'s NMS candidates in score order: boxes (n, 9)
    [x, y, z, w, l, h, yaw, vx, vy], scores (n,), classes (n,) over all
    tasks' classes; and the score of the last one the top-k kept when it
    dropped any, else 0."""

    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    cut: float


@torch.no_grad()
def decode(maps, cfg):
    """Dense maps (B, C, h, w) -> [[Candidates of each task] of each
    cloud]."""
    B, _, h, w = maps.shape
    dev = maps.device
    cols = torch.arange(w, device=dev, dtype=maps.dtype)
    rows = torch.arange(h, device=dev, dtype=maps.dtype)[:, None]
    lim, lim_z = cfg.post_center_limit, cfg.post_center_limit_z
    out = [[] for _ in range(B)]
    at, first_class = 0, 0
    for t in range(len(cfg.tasks)):
        ch = {}
        for name, n in heads(cfg, t):
            ch[name] = maps[:, at:at + n]
            at += n
        hm = torch.sigmoid(ch["hm"])
        score, label = hm[:, 0], torch.zeros_like(hm[:, 0], dtype=torch.long)
        for k in range(1, hm.shape[1]):         # ties to the lower class
            better = hm[:, k] > score
            score = torch.where(better, hm[:, k], score)
            label = torch.where(better, k, label)
        x = ((cols + ch["reg"][:, 0]) * float(cfg.out_stride)) \
            * cfg.voxel_x + cfg.x_min
        y = ((rows + ch["reg"][:, 1]) * float(cfg.out_stride)) \
            * cfg.voxel_y + cfg.y_min
        z = ch["height"][:, 0]
        dims = torch.exp(ch["dim"])
        yaw = torch.atan2(ch["rot"][:, 0], ch["rot"][:, 1])
        rows9 = torch.stack([x, y, z, dims[:, 0], dims[:, 1], dims[:, 2],
                             yaw, ch["vel"][:, 0], ch["vel"][:, 1]],
                            dim=-1).reshape(B, h * w, 9).cpu().numpy()
        keep = ((score > cfg.score_threshold) & (x >= -lim) & (x <= lim)
                & (y >= -lim) & (y <= lim) & (z >= -lim_z) & (z <= lim_z))
        score = score.reshape(B, -1).cpu().numpy()
        label = label.reshape(B, -1).cpu().numpy()
        keep = keep.reshape(B, -1).cpu().numpy()
        for b in range(B):
            cand = np.nonzero(keep[b])[0]
            top = cand[np.argsort(-score[b][cand], kind="stable")]
            top = top[:cfg.nms_pre]
            cut = (float(score[b][top[-1]]) if len(cand) > len(top)
                   else 0.0)
            out[b].append(Candidates(rows9[b][top], score[b][top],
                                     label[b][top] + first_class, cut))
        first_class += len(cfg.tasks[t].classes)
    return out


class CenterDetections(NamedTuple):
    """One cloud's detections, task after task: boxes (n, 9), scores (n,),
    classes (n,), tasks (n,); each task's candidates (``Candidates``);
    and, per task, the score of the last detection kept when NMS stopped
    at ``nms_post``, else 0."""

    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    tasks: np.ndarray
    candidates: list
    post_cut: np.ndarray


def postprocess(cands, cfg) -> CenterDetections:
    """One cloud's candidates of each task -> :class:`CenterDetections`."""
    boxes, scores, classes, tasks, post_cut = [], [], [], [], []
    for t, c in enumerate(cands):
        keep = nms(c.boxes, cfg.nms_iou, cfg.nms_post)
        boxes.append(c.boxes[keep])
        scores.append(c.scores[keep])
        classes.append(c.classes[keep])
        tasks.append(np.full(len(keep), t, np.int64))
        post_cut.append(float(c.scores[keep[-1]])
                        if len(keep) == cfg.nms_post else 0.0)
    return CenterDetections(np.concatenate(boxes).reshape(-1, 9),
                            np.concatenate(scores),
                            np.concatenate(classes).astype(np.int64),
                            np.concatenate(tasks), list(cands),
                            np.asarray(post_cut))


class ReferenceCenterPoint:
    """The reference pipeline over clouds, ``batch`` clouds a forward, on
    ``device`` in float32 (``allow_tf32`` False) or, as the benchmark's
    control, TF32 (``allow_tf32`` True). ``weights``: the port's state
    dict (names of ``models.centerpoint.CenterPoint``)."""

    def __init__(self, cfg, weights: dict, device="cpu", batch: int = 8,
                 allow_tf32: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch = batch
        self.allow_tf32 = allow_tf32
        self.w = {k: v.detach().to(self.device, torch.float32)
                  for k, v in weights.items()}
        self.occupied = []

    def maps(self, clouds):
        """List of (n, F) clouds -> dense maps (len, C, h, w) on the
        device."""
        out = []
        for at in range(0, len(clouds), self.batch):
            chunk = [pillarize(crop_and_budget(c, self.cfg), self.cfg)
                     for c in clouds[at:at + self.batch]]
            self.occupied += [c[4] for c in chunk]
            t = [torch.as_tensor(np.stack(x), device=self.device)
                 for x in list(zip(*chunk))[:4]]
            with tf32(self.allow_tf32):
                out.append(forward(self.w, self.cfg, *t))
        return torch.cat(out)

    def detect(self, clouds):
        """List of (n, F) clouds -> list of :class:`CenterDetections`."""
        out = []
        for at in range(0, len(clouds), self.batch):
            maps = self.maps(clouds[at:at + self.batch])
            out += [postprocess(c, self.cfg) for c in decode(maps, self.cfg)]
        return out
