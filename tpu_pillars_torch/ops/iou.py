"""Exact rotated-box BEV IoU, plain PyTorch — port of
``tpu_pillars/ops/iou.py``.

Sort-free and gather-free, via Green's theorem: for convex polygons

    area(A ^ B) = sum_{edges e of A} int_{e ^ B} x dy
                + sum_{edges e of B} int_{e ^ A} x dy

Each edge clips against the other quad's 4 half-planes in closed form (a
parameter interval [t_lo, t_hi] carried as homogeneous p/q pairs), then
contributes a closed-form line integral. The arithmetic, its order and its
scale-relative degeneracy thresholds are the JAX package's, op for op: the
NMS overlap kernel (``csrc/nms_overlap.cu``) repeats them with no fused
multiply-adds, so kernel and plain version round alike.

Boxes are packed ``[x, y, z, w, l, h, yaw]`` (z/h are ignored by the BEV
functions); the quad functions broadcast over leading dims, the pairwise
ones take (N, 7) x (M, 7), :func:`rotated_iou_bev_colchunked` any
broadcastable leading dims (the dense target assigner's samples and
classes). ``ops/iou_tiled.py`` holds K7, the
tiled variant.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def corners_bev(boxes):
    """(..., 7) -> (..., 4, 2) BEV footprint corners, CCW from front-left."""
    x, y = boxes[..., 0], boxes[..., 1]
    w, l, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    lx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], dim=-1)
    ly = torch.stack([w / 2, w / 2, -w / 2, -w / 2], dim=-1)
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    gx = x[..., None] + c * lx - s * ly
    gy = y[..., None] + s * lx + c * ly
    return torch.stack([gx, gy], dim=-1)


def _fmin2(p1, q1, p2, q2):
    """min(p1/q1, p2/q2) with q > 0, division-free."""
    take1 = p1 * q2 < p2 * q1
    return torch.where(take1, p1, p2), torch.where(take1, q1, q2)


def _fmax2(p1, q1, p2, q2):
    take1 = p1 * q2 > p2 * q1
    return torch.where(take1, p1, p2), torch.where(take1, q1, q2)


def _half_edge_integral(px, py, cx, cy):
    """Sum over the `p` quad's edges of int x dy restricted to the inside of
    the convex CCW `c` quad. Arguments are length-4 lists of broadcastable
    tensors (one per corner)."""
    big = 1e9
    nx = [cy[(k + 1) % 4] - cy[k] for k in range(4)]
    ny = [cx[k] - cx[(k + 1) % 4] for k in range(4)]
    cc = [nx[k] * cx[k] + ny[k] * cy[k] for k in range(4)]
    # scale-relative degeneracy thresholds (see the JAX package's iou.py):
    # |nd| <= rel * |d||n| (L1 norms) counts as parallel
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
        ph, qh = one, one                      # t_hi starts at the cap 1
        pl, ql = torch.zeros_like(x1), one     # t_lo starts at the floor 0
        for k in range(4):
            f0 = x1 * nx[k] + y1 * ny[k] - cc[k]
            nd = dx * nx[k] + dy * ny[k]
            parallel = torch.abs(nd) <= rel * (dlen * nlen[k]) + _EPS
            violated = parallel & (
                f0 > rel * (plen * nlen[k] + torch.abs(cc[k])) + _EPS)
            exiting = ~parallel & (nd > 0)
            entering = ~parallel & (nd < 0)
            hp = torch.where(exiting, -f0,
                             torch.where(violated, -big, big))
            hq = torch.where(exiting, nd, one)
            lp = torch.where(entering, f0,
                             torch.where(violated, big, -big))
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


def convex_quad_intersect_area(qa, qb):
    """Intersection area of CCW quads qa, qb: (..., 4, 2) -> (...,), with
    broadcasting over the leading dims. Coordinates are re-centred per pair
    before integrating (f32 cancellation scales with |coordinate|)."""
    ax = [qa[..., e, 0] for e in range(4)]
    ay = [qa[..., e, 1] for e in range(4)]
    bx = [qb[..., e, 0] for e in range(4)]
    by = [qb[..., e, 1] for e in range(4)]
    midx = 0.125 * (ax[0] + ax[1] + ax[2] + ax[3]
                    + bx[0] + bx[1] + bx[2] + bx[3])
    midy = 0.125 * (ay[0] + ay[1] + ay[2] + ay[3]
                    + by[0] + by[1] + by[2] + by[3])
    ax = [x - midx for x in ax]
    ay = [y - midy for y in ay]
    bx = [x - midx for x in bx]
    by = [y - midy for y in by]
    area = (_half_edge_integral(ax, ay, bx, by)
            + _half_edge_integral(bx, by, ax, ay))
    return torch.clamp(area, min=0.0)


def _iou_broadcast(boxes1, boxes2):
    """Rotated BEV IoU of boxes1 (..., 7) and boxes2 (..., 7), pair by pair
    over their broadcast leading dims; the JAX ``rotated_iou_bev``'s
    operations in its order, with boxes1 first."""
    inter = convex_quad_intersect_area(corners_bev(boxes1),
                                       corners_bev(boxes2))
    a1 = boxes1[..., 3] * boxes1[..., 4]
    a2 = boxes2[..., 3] * boxes2[..., 4]
    # exact gate: footprints cannot meet beyond the sum of circumradii
    dx = boxes1[..., 0] - boxes2[..., 0]
    dy = boxes1[..., 1] - boxes2[..., 1]
    r1 = 0.5 * torch.sqrt(boxes1[..., 3] ** 2 + boxes1[..., 4] ** 2)
    r2 = 0.5 * torch.sqrt(boxes2[..., 3] ** 2 + boxes2[..., 4] ** 2)
    rr = r1 + r2
    inter = torch.where(dx * dx + dy * dy > rr * rr, 0.0, inter)
    inter = torch.minimum(inter, torch.minimum(a1, a2))
    union = torch.clamp(a1 + a2 - inter, min=_EPS)
    return torch.clamp(inter / union, 0.0, 1.0)


def rotated_iou_bev(boxes1, boxes2):
    """Pairwise rotated BEV IoU. boxes1 (N, 7), boxes2 (M, 7) -> (N, M)."""
    return _iou_broadcast(boxes1[:, None], boxes2[None, :])


def rotated_iou_bev_paired(boxes1, boxes2):
    """Row-paired rotated BEV IoU: boxes1 (..., G, 7) against boxes2 (...,
    G, K, 7) -> (..., G, K), row g comparing boxes1[g] with boxes2[g, :]
    (the banded target assigner's windows of anchors around each GT). The
    circumradius gate and the clamps of :func:`rotated_iou_bev`, boxes1
    first."""
    return _iou_broadcast(boxes1[..., None, :], boxes2)


def _iou_gated(boxes1, boxes2):
    """:func:`_iou_broadcast`'s values, the polygon clip computed only for
    the pairs that pass its circumradius gate: a pair beyond it reads
    exactly 0 there, and each op is elementwise, so a gathered pair rounds
    as it does in the broadcast. (The gather syncs the host once.)"""
    shape = torch.broadcast_shapes(boxes1.shape, boxes2.shape)
    b1, b2 = boxes1.expand(shape), boxes2.expand(shape)
    dx = b1[..., 0] - b2[..., 0]
    dy = b1[..., 1] - b2[..., 1]
    rr = (0.5 * torch.sqrt(b1[..., 3] ** 2 + b1[..., 4] ** 2)
          + 0.5 * torch.sqrt(b2[..., 3] ** 2 + b2[..., 4] ** 2))
    hot = torch.nonzero(~(dx * dx + dy * dy > rr * rr), as_tuple=True)
    out = boxes1.new_zeros(shape[:-1])
    out[hot] = _iou_broadcast(b1[hot], b2[hot])
    return out


def rotated_iou_bev_colchunked(boxes1, boxes2, chunk: int = 16384):
    """Column-chunked rotated BEV IoU: a few boxes1 (..., N, 7) against many
    boxes2 (..., M, 7) -> (..., N, M), the leading dims broadcast (port of
    the JAX ``rotated_iou_bev_colchunked``, which takes no leading dims).
    Each chunk of ``chunk`` columns gives ``rotated_iou_bev(boxes1,
    cols)``'s values bit for bit, its polygon clip run only on the pairs
    that pass the circumradius gate (:func:`_iou_gated`), and the chunk
    bounds the transient memory. The JAX version pads the last chunk with
    boxes of ones to keep its shapes static and drops their columns; here
    the last chunk is short, which gives the same values."""
    m = boxes2.shape[-2]
    chunk = max(1, min(chunk, m))
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    out = boxes1.new_empty(lead + (boxes1.shape[-2], m))
    b1 = boxes1[..., :, None, :]
    for s in range(0, m, chunk):
        out[..., s:s + chunk] = _iou_gated(
            b1, boxes2[..., None, s:s + chunk, :])
    return out


def _bev_disjoint(boxes1, boxes2):
    """(N, 7), (M, 7) -> (N, M) bool: pairs whose footprints cannot meet
    (centre distance beyond the sum of circumradii)."""
    dx = boxes1[:, None, 0] - boxes2[None, :, 0]
    dy = boxes1[:, None, 1] - boxes2[None, :, 1]
    r1 = 0.5 * torch.sqrt(boxes1[:, 3] ** 2 + boxes1[:, 4] ** 2)
    r2 = 0.5 * torch.sqrt(boxes2[:, 3] ** 2 + boxes2[:, 4] ** 2)
    rr = r1[:, None] + r2[None, :]
    return dx * dx + dy * dy > rr * rr


def rotated_iou_bev_chunked(boxes1, boxes2, chunk: int = 4096):
    """Row-chunked rotated BEV IoU, (N, 7) x (M, 7) -> (N, M), for a large
    boxes1. As in the JAX package, each chunk of rows is computed in the
    (M, chunk) orientation, ``rotated_iou_bev(boxes2, rows)``, then
    transposed: the pair arithmetic runs with boxes2 first, which is what
    ``ops.nms.rotated_nms`` rounds like. Chunks bound the transient memory;
    padding rows are never computed."""
    n = boxes1.shape[0]
    chunk = max(1, min(chunk, n))
    parts = [rotated_iou_bev(boxes2, boxes1[s:s + chunk]).T
             for s in range(0, n, chunk)]
    if not parts:
        return boxes1.new_zeros((0, boxes2.shape[0]))
    return torch.cat(parts, dim=0)


def iou_3d(boxes1, boxes2):
    """Pairwise 3-D IoU, (N, 7) x (M, 7) -> (N, M): rotated BEV
    intersection times the z overlap, over the volume union."""
    c1 = corners_bev(boxes1)[:, None]
    c2 = corners_bev(boxes2)[None, :]
    inter_bev = convex_quad_intersect_area(c1, c2)
    z1_lo = boxes1[:, 2] - boxes1[:, 5] / 2
    z1_hi = boxes1[:, 2] + boxes1[:, 5] / 2
    z2_lo = boxes2[:, 2] - boxes2[:, 5] / 2
    z2_hi = boxes2[:, 2] + boxes2[:, 5] / 2
    z_olap = torch.clamp(
        torch.minimum(z1_hi[:, None], z2_hi[None, :])
        - torch.maximum(z1_lo[:, None], z2_lo[None, :]), min=0.0)
    inter_bev = torch.where(_bev_disjoint(boxes1, boxes2), 0.0, inter_bev)
    inter_bev = torch.minimum(
        inter_bev,
        torch.minimum((boxes1[:, 3] * boxes1[:, 4])[:, None],
                      (boxes2[:, 3] * boxes2[:, 4])[None, :]))
    inter = inter_bev * z_olap
    v1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    v2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    union = torch.clamp(v1 + v2 - inter, min=_EPS)
    return torch.clamp(inter / union, 0.0, 1.0)
