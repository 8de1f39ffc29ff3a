"""The training reference: the PointPillars training step in plain
PyTorch, run from the benchmark's initial weights on the benchmark's
batches, for the first steps of a training cell, and from the program's
own state for a step of its window.

The step, as the detector's training is published (PointPillars, arXiv
1812.05784) and as the port states it:

* pillars (first ``max_pillars`` by ascending id, first
  ``max_points_per_pillar`` points of each in input order), decorated with
  the offsets to the pillar's mean and cell centre; the PFN linear, a
  BatchNorm on the batch statistics of the valid points (biased, ``var =
  max(E[y^2] - E[y]^2, 0)``), ReLU, max over the pillar's points;
* the dense canvas; the RPN on batch statistics (the same BatchNorm rule,
  eps 1e-3); the 1x1 head, anchors in (row, col, class * yaws + yaw) order;
* targets by rotated BEV IoU against every anchor of the GT's class: the
  best GT per anchor (first slot on ties), each GT's best anchor forced
  positive (lowest anchor on ties, the highest claiming slot wins),
  ``matched_iou`` / ``unmatched_iou`` thresholds; the IoU is the port's
  closed-form Green's-theorem intersection, op for op (a threshold decision
  must not turn on rounding), with the circumradius gate;
* sigmoid focal loss (alpha, gamma), smooth-L1 (beta 1/9) on the residuals
  with the sin angle term, 2-way direction cross-entropy, each over the
  positives, the batch mean of their weighted sum;
* optax's ``chain(clip_by_global_norm, adamw)`` with its warmup-cosine
  schedule, decaying every parameter.

Weights come in the port's parameter names and layouts (the benchmark
makes them): ``pfn.kernel`` (D, C); ``rpn.blocks.i.convs.j`` (out, in, 3,
3); ``rpn.ups.i.weight`` (in, out, s, s); ``head.<cls|box|dir>.weight``
(C, anchors_per_loc * k), column ``a_loc * k + feature``; BatchNorms as
``<prefix>.weight`` / ``.bias``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pillarbench.reference.detect import pillarize, tf32
from pillarbench.reference.geometry import box_corners_bev, make_anchors

BN_EPS = 1e-3
_EPS = 1e-6


def is_parameter(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


# ---- the model on batch statistics ----

def _bn_train(x, scale, bias, dims):
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    shape = [1] * x.dim()
    shape[1] = -1
    mul = (torch.rsqrt(var + BN_EPS) * scale).reshape(shape)
    return (xf - mean.reshape(shape)) * mul + bias.reshape(shape)


def pfn_train(w, feats, mask, pillar_mask):
    """(B, P, N, D) decorated points -> (B, P, C) pillar features."""
    y = feats @ w["pfn.kernel"]                                # B P N C
    m = mask[..., None].to(y.dtype)
    n = torch.clamp(m.sum(), min=1.0)
    mean = (y * m).sum(dim=(0, 1, 2)) / n
    var = torch.clamp((y * y * m).sum(dim=(0, 1, 2)) / n - mean * mean,
                      min=0.0)
    yn = ((y - mean) * (torch.rsqrt(var + BN_EPS) * w["pfn.bn.weight"])
          + w["pfn.bn.bias"])
    yn = torch.relu(yn)
    yn = torch.where(mask[..., None], yn, torch.full_like(yn, -1e9))
    out = yn.amax(dim=2)
    return torch.where(pillar_mask[..., None], out, torch.zeros_like(out))


def canvas_of(x, coords, pillar_mask, cfg):
    """(B, P, C) features -> (B, C, H, W) canvas (differentiable)."""
    B, P, C = x.shape
    HW = cfg.grid_h * cfg.grid_w
    flat = (coords[..., 0].long() * cfg.grid_w + coords[..., 1].long()
            + torch.arange(B, device=x.device)[:, None] * HW)
    live = pillar_mask.reshape(-1)
    canvas = torch.zeros((B * HW, C), dtype=x.dtype, device=x.device)
    canvas = canvas.index_copy(0, flat.reshape(-1)[live],
                               x.reshape(B * P, C)[live])
    return canvas.reshape(B, cfg.grid_h, cfg.grid_w, C).permute(0, 3, 1, 2)


def rpn_train(w, x, cfg):
    ups = []
    for i, n in enumerate(cfg.rpn_layers):
        for j in range(n):
            x = F.conv2d(x, w[f"rpn.blocks.{i}.convs.{j}"],
                         stride=2 if j == 0 else 1, padding=1)
            p = f"rpn.blocks.{i}.bns.{j}"
            x = torch.relu(_bn_train(x, w[p + ".weight"], w[p + ".bias"],
                                     (0, 2, 3)))
        u = F.conv_transpose2d(x, w[f"rpn.ups.{i}.weight"], stride=2 ** i)
        p = f"rpn.ups.{i}.bn"
        ups.append(torch.relu(_bn_train(u, w[p + ".weight"], w[p + ".bias"],
                                        (0, 2, 3))))
    return torch.cat(ups, dim=1)


def head_fm(w, feat, cfg):
    """(B, Cf, Hf, Wf) -> cls (B, K, A), box (B, 7, A), dir (B, 2, A)."""
    B, C, H, W = feat.shape
    f = feat.permute(0, 2, 3, 1).reshape(B, H * W, C)
    a_loc = cfg.anchors_per_loc

    def one(name, k):
        out = f @ w[f"head.{name}.weight"] + w[f"head.{name}.bias"]
        return out.reshape(B, H * W * a_loc, k).transpose(1, 2)

    return one("cls", cfg.num_classes), one("box", 7), one("dir", 2)


# ---- targets: rotated IoU by Green's theorem, op for op ----

def _corners(boxes):
    x, y = boxes[..., 0], boxes[..., 1]
    w, l, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    lx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], dim=-1)
    ly = torch.stack([w / 2, w / 2, -w / 2, -w / 2], dim=-1)
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    return torch.stack([x[..., None] + c * lx - s * ly,
                        y[..., None] + s * lx + c * ly], dim=-1)


def _fmin2(p1, q1, p2, q2):
    take1 = p1 * q2 < p2 * q1
    return torch.where(take1, p1, p2), torch.where(take1, q1, q2)


def _fmax2(p1, q1, p2, q2):
    take1 = p1 * q2 > p2 * q1
    return torch.where(take1, p1, p2), torch.where(take1, q1, q2)


def _half_edge_integral(px, py, cx, cy):
    """Sum over the edges of quad p of the integral of x dy inside the
    convex CCW quad c; corners as lists of four broadcastable tensors."""
    big = 1e9
    nx = [cy[(k + 1) % 4] - cy[k] for k in range(4)]
    ny = [cx[k] - cx[(k + 1) % 4] for k in range(4)]
    cc = [nx[k] * cx[k] + ny[k] * cy[k] for k in range(4)]
    rel = 3e-4
    nlen = [torch.abs(nx[k]) + torch.abs(ny[k]) for k in range(4)]
    total = None
    for e in range(4):
        x1, y1 = px[e], py[e]
        dx = px[(e + 1) % 4] - x1
        dy = py[(e + 1) % 4] - y1
        dlen = torch.abs(dx) + torch.abs(dy)
        plen = torch.abs(x1) + torch.abs(y1)
        one = torch.ones_like(x1)
        ph, qh = one, one
        pl, ql = torch.zeros_like(x1), one
        for k in range(4):
            f0 = x1 * nx[k] + y1 * ny[k] - cc[k]
            nd = dx * nx[k] + dy * ny[k]
            parallel = torch.abs(nd) <= rel * (dlen * nlen[k]) + _EPS
            violated = parallel & (
                f0 > rel * (plen * nlen[k] + torch.abs(cc[k])) + _EPS)
            exiting = ~parallel & (nd > 0)
            entering = ~parallel & (nd < 0)
            hp = torch.where(exiting, -f0, torch.where(violated, -big, big))
            hq = torch.where(exiting, nd, one)
            lp = torch.where(entering, f0, torch.where(violated, big, -big))
            lq = torch.where(entering, -nd, one)
            ph, qh = _fmin2(ph, qh, hp, hq)
            pl, ql = _fmax2(pl, ql, lp, lq)
        cross = ph * ql - pl * qh
        mixed = ph * ql + pl * qh
        inv = 1.0 / (qh * ql)
        contrib = dy * cross * inv * (x1 + 0.5 * dx * mixed * inv)
        contrib = torch.where(cross > 0, contrib, 0.0)
        total = contrib if total is None else total + contrib
    return total


def anchor_planes(cfg, device):
    """(C, 12, Ac) f32 per class, anchors in class-block order: corner xs,
    corner ys, centre x, y, BEV area, circumradius."""
    C, Y = cfg.num_classes, len(cfg.anchor_yaws)
    Hf, Wf = cfg.feature_h, cfg.feature_w
    anchors, _ = make_anchors(cfg)
    by = (anchors.reshape(Hf, Wf, C, Y, 7).transpose(2, 0, 1, 3, 4)
          .reshape(C, Hf * Wf * Y, 7))
    cs = box_corners_bev(by.reshape(-1, 7)).astype(np.float32).reshape(
        C, Hf * Wf * Y, 4, 2)
    planes = np.empty((C, 12, Hf * Wf * Y), np.float32)
    for k in range(4):
        planes[:, k] = cs[..., k, 0]
        planes[:, 4 + k] = cs[..., k, 1]
    planes[:, 8] = by[..., 0]
    planes[:, 9] = by[..., 1]
    planes[:, 10] = by[..., 3] * by[..., 4]
    planes[:, 11] = 0.5 * np.sqrt(by[..., 3] ** 2 + by[..., 4] ** 2)
    return torch.from_numpy(planes).to(device)


def class_iou(gt_c, gv_c, planes):
    """One sample: gt_c (C, Gc, 7), gv_c (C, Gc) -> IoU (C, Gc, Ac), -1 for
    empty slots, 0 beyond the sum of circumradii."""
    ap = planes[:, None]
    apx = [ap[:, :, q] for q in range(4)]
    apy = [ap[:, :, 4 + q] for q in range(4)]
    corners = _corners(gt_c)
    gpx = [corners[..., q, 0][..., None] for q in range(4)]
    gpy = [corners[..., q, 1][..., None] for q in range(4)]
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
    dx = gt_c[..., 0:1] - ap[:, :, 8]
    dy = gt_c[..., 1:2] - ap[:, :, 9]
    g_area = (gt_c[..., 3] * gt_c[..., 4])[..., None]
    g_rad = (0.5 * torch.sqrt(gt_c[..., 3] ** 2 + gt_c[..., 4] ** 2))[..., None]
    rr = g_rad + ap[:, :, 11]
    a2 = ap[:, :, 10]
    inter = torch.minimum(inter, torch.minimum(g_area, a2))
    union = torch.clamp(g_area + a2 - inter, min=_EPS)
    iou = torch.clamp(inter / union, 0.0, 1.0)
    iou = torch.where(dx * dx + dy * dy > rr * rr, 0.0, iou)
    return torch.where(gv_c[..., None], iou, -1.0)


def group_by_class(gt_boxes, gt_cls, gt_valid, C, cap):
    """(B, G, 7) -> (B, C, cap, 7) boxes and (B, C, cap) validity: each
    class keeps its first ``cap`` valid GT in input order."""
    B, G, _ = gt_boxes.shape
    boxes = torch.zeros((B, C, cap, 7), dtype=gt_boxes.dtype,
                        device=gt_boxes.device)
    valid = torch.zeros((B, C, cap), dtype=torch.bool, device=gt_boxes.device)
    gb, gc, gv = (t.cpu().numpy() for t in (gt_boxes, gt_cls, gt_valid))
    for b in range(B):
        fill = [0] * C
        for g in range(G):
            c = int(gc[b, g])
            if gv[b, g] and 0 <= c < C and fill[c] < cap:
                boxes[b, c, fill[c]] = gt_boxes[b, g]
                valid[b, c, fill[c]] = True
                fill[c] += 1
    return boxes, valid


def targets(cfg, gt_boxes, gt_cls, gt_valid, cap, planes, anchor_ch,
            anchor_cls):
    """Feature-major targets of a batch: (cls_onehot (B, K, A), reg (B, 7,
    A), dir (B, A), cls_weights (B, A), reg_weights (B, A), num_pos (B,))."""
    C, Y = cfg.num_classes, len(cfg.anchor_yaws)
    HW = cfg.feature_h * cfg.feature_w
    A = cfg.num_anchors
    dev = gt_boxes.device
    gt_c, gv_c = group_by_class(gt_boxes, gt_cls, gt_valid, C, cap)
    B = gt_c.shape[0]
    matched = torch.tensor([c.matched_iou for c in cfg.classes],
                           dtype=torch.float32, device=dev)
    unmatched = torch.tensor([c.unmatched_iou for c in cfg.classes],
                             dtype=torch.float32, device=dev)
    out = []
    for b in range(B):
        iou = class_iou(gt_c[b], gv_c[b], planes)              # C Gc Ac
        best, best_gt = iou.amax(dim=1), torch.argmax(iou, dim=1)
        gt_val, gt_anchor = iou.amax(dim=2), torch.argmax(iou, dim=2)
        Ac = best.shape[1]
        claim = gv_c[b] & (gt_val > 0.0)
        forced = torch.zeros((C, Ac), dtype=torch.bool, device=dev)
        forced_gt = torch.full((C, Ac), -1, dtype=torch.int64, device=dev)
        for c in range(C):
            for g in range(cap):
                if claim[c, g]:
                    a = gt_anchor[c, g]
                    forced[c, a] = True
                    forced_gt[c, a] = torch.maximum(forced_gt[c, a],
                                                    torch.tensor(g, device=dev))
        pos = (best >= matched[:, None]) | forced
        neg = (best < unmatched[:, None]) & ~pos
        assigned = torch.where(forced & (forced_gt >= 0), forced_gt, best_gt)
        # class-block (C, Hf, Wf, Y) -> flat (Hf, Wf, C, Y)
        def flat(t):
            return t.reshape(C, HW, Y).permute(1, 0, 2).reshape(A)
        pos, neg, assigned = flat(pos), flat(neg), flat(assigned)
        picked = gt_c[b].reshape(C * cap, 7)[anchor_cls * cap + assigned].t()
        px, py, pz, pw, pl, ph, pt = picked.unbind(0)
        xa, ya, za, wa, la, ha, ta = anchor_ch.unbind(0)
        d = torch.sqrt(wa * wa + la * la)
        reg = torch.stack([(px - xa) / d, (py - ya) / d, (pz - za) / ha,
                           torch.log(pw / wa), torch.log(pl / la),
                           torch.log(ph / ha), pt - ta])
        reg = torch.where(pos[None], reg, 0.0)
        posf = pos.to(torch.float32)
        onehot = (anchor_cls[None, :] == torch.arange(C, device=dev)[:, None]
                  ).to(torch.float32) * posf[None]
        out.append((onehot, reg, ((pt > 0.0) & pos).to(torch.int32),
                    (pos | neg).to(torch.float32), posf, posf.sum()))
    return tuple(torch.stack(x) for x in zip(*out))


def losses(cfg, cls, box, dirs, tg):
    """Per-sample (total, cls, loc, dir) from feature-major outputs."""
    onehot, reg_t, dir_t, cls_w, reg_w, num_pos = tg
    norm = torch.clamp(num_pos, min=1.0)
    a, g = cfg.focal_alpha, cfg.focal_gamma
    p = torch.sigmoid(cls)
    ce = (torch.clamp(cls, min=0.0) - cls * onehot
          + torch.log1p(torch.exp(-torch.abs(cls))))
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = a * onehot + (1.0 - a) * (1.0 - onehot)
    focal = alpha_t * (1.0 - p_t) ** g * ce
    cls_loss = (focal * cls_w[:, None, :]).sum(dim=(-2, -1)) / norm
    diff = box - reg_t
    angle = torch.sin(box[:, 6] - reg_t[:, 6])
    diff = torch.cat([diff[:, :6], angle[:, None]], dim=1)
    ad = torch.abs(diff)
    beta = 1.0 / 9.0
    sl1 = torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)
    loc_loss = (sl1 * reg_w[:, None, :]).sum(dim=(-2, -1)) / norm
    logp = torch.log_softmax(dirs, dim=1)
    dir_el = -torch.where(dir_t == 1, logp[:, 1], logp[:, 0])
    dir_loss = (dir_el * reg_w).sum(dim=-1) / norm
    total = (cfg.pos_weight_cls * cls_loss + cfg.weight_loc * loc_loss
             + cfg.weight_dir * dir_loss)
    return total, cls_loss, loc_loss, dir_loss


# ---- optax chain(clip_by_global_norm, adamw(warmup cosine)) ----

def learning_rate(opt: dict, count: int) -> float:
    f32 = np.float32
    lr = f32(opt["learning_rate"])
    warmup = max(1, int(round(opt["total_steps"] * opt["warmup_frac"])))
    decay = max(1, opt["total_steps"] - warmup)
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        span = f32(opt["learning_rate"] / 25.0 - opt["learning_rate"])
        return float(span * frac + lr)
    t = f32(min(float(count - warmup), float(decay)))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay)))
    return float(lr * (f32(1.0 - 1e-4) * cosine + f32(1e-4)))


class AdamW:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, opt: dict):
        self.params = params
        self.opt = opt
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """One update; returns the clipped gradients it used."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        max_norm = self.opt["grad_clip_norm"]
        keep = norm < max_norm
        used = {k: torch.where(keep, g, (g / norm) * max_norm)
                for k, g in grads.items()}
        n = self.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(n))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(n))
        lr = learning_rate(self.opt, self.count)
        wd = self.opt["weight_decay"]
        for k, p in self.params.items():
            g, mu, nu = used[k], self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + wd * p
            p.add_((-lr) * u)
        self.count = n
        return used


def train_steps(weights: dict, cfg, batches, opt: dict, cap: int, device,
                allow_tf32: bool = False, start: dict = None):
    """Run ``len(batches)`` steps from ``weights`` ({name: tensor}, port
    names) on numpy batches (points, num_points, gt_boxes, gt_classes,
    gt_valid). ``start``: the optimizer's state to go on from, {"count":
    the steps taken, "mu", "nu": {name: tensor}}; None for a fresh one.
    Returns {"losses": [float], "grad1": {name: the clipped gradient of
    the first of these steps}, "params": {name: the parameters after the
    last step}}."""
    device = torch.device(device)
    params = {k: v.detach().to(device, torch.float32).clone()
              for k, v in weights.items() if is_parameter(k)}
    opt_state = AdamW(params, opt)
    if start is not None:
        opt_state.count = int(start["count"])
        for k in params:
            opt_state.mu[k].copy_(torch.as_tensor(start["mu"][k]))
            opt_state.nu[k].copy_(torch.as_tensor(start["nu"][k]))
    planes = anchor_planes(cfg, device)
    anchors, anchor_cls = make_anchors(cfg)
    anchor_ch = torch.from_numpy(np.ascontiguousarray(anchors.T)).to(device)
    acls = torch.from_numpy(anchor_cls).to(device)
    out = {"losses": [], "grad1": None, "params": None}
    for pts, npts, gb, gc, gv in batches:
        chunk = [pillarize(pts[b, :int(npts[b])], cfg)
                 for b in range(len(npts))]
        feats, mask, coords, pmask = (torch.as_tensor(np.stack(x),
                                                      device=device)
                                      for x in zip(*chunk))
        with torch.no_grad():
            tg = targets(cfg, torch.as_tensor(gb, device=device),
                         torch.as_tensor(gc, device=device).long(),
                         torch.as_tensor(gv, device=device), cap, planes,
                         anchor_ch, acls)
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        with tf32(allow_tf32):
            x = pfn_train(params, feats, mask, pmask)
            canvas = canvas_of(x, coords, pmask, cfg)
            feat = rpn_train(params, canvas, cfg)
            total = losses(cfg, *head_fm(params, feat, cfg), tg)[0].mean()
            total.backward()
        grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.requires_grad_(False)
        used = opt_state.step(grads)
        out["losses"].append(float(total.detach()))
        if out["grad1"] is None:
            out["grad1"] = {k: g.clone() for k, g in used.items()}
        del feats, mask, x, canvas, feat, total, grads
    out["params"] = {k: p.clone() for k, p in params.items()}
    return out
