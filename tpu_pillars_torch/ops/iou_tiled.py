"""K7 tiled rotated BEV IoU — port of ``tpu_pillars/ops/iou_pallas.py``
(named ``iou_tiled`` here because ``ops/iou.py`` holds the dense path).

The same Green's-theorem IoU as ``ops.iou.rotated_iou_bev``, with the JAX
kernel's own clipping arithmetic (a division per half-plane and absolute
``EPS`` tests, not the dense path's division-free, scale-relative ones) and
one difference that makes its result depend on the tiling: each
(block_i, block_j) tile is recentred at its JOINT MEAN,

    mx = 0.5 * (sum(x_i over the tile's rows) / block_i
                + sum(x_j over the tile's columns) / block_j),

and the rows and columns that pad N and M to whole tiles are boxes of ones,
which count in that mean. Both versions here tile the same way, so they
agree with the JAX kernel to rounding; against the dense path they agree
only to the tile recentring's f32 noise (the JAX tests hold the two at atol
1e-3).

On a CUDA tensor :func:`rotated_iou_bev_tiled` makes one launch of
``csrc/iou_tiled.cu`` and dispatches no torch op but the ``torch.empty`` of
its output: the kernel reads the boxes through their strides (a view such
as ``cands[..., :7]`` is not copied), computes cos and sin of the yaws
itself and treats rows and columns past N and M as the fillers. On a CPU
tensor it runs :func:`rotated_iou_bev_tiled_plain`. Both take the tile sums
as a halving tree over the tile padded with zeros to a power of two, cos
and sin as the card's ``cosf`` and ``sinf``, and a tile's mean as torch
takes ``sum / block`` of a CUDA tensor: a product with the f32 reciprocal
of the block (on a CPU tensor torch divides, which differs by an ulp of
the mean where the block is not a power of two). So on the card they
agree to rounding. A leading batch dim is accepted: (B, N, 7) x (B, M, 7)
-> (B, N, M) in one launch.

What bounds K7 on the card is arithmetic: ~850 operations and 32 IEEE
divisions for each pair that passes the circumradius gate. The first
kernel (one CUDA block per JAX tile, the gate a branch in every thread's
walk over the tile) paid that for nearly every pair, since hot pairs are
spread over a tile and a warp with one hot lane runs the whole path; its
wrapper built the payload in six or more torch launches. The kernel now
gives a CUDA block a 64 x 64 sub-range of its JAX tile (still recentred at
the whole tile's mean), builds a table of each box's corners and
half-planes once, lists the pairs that pass the gate and clips only those,
and starts the blocks that hold the most hot pairs first.
``csrc/iou_tiled.cu`` has the details, ``PERF.md`` section 6 the times.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build

_EPS = 1e-6
_BIG = 1e9
MAX_BLOCK = 256      # the largest tile side the CUDA kernel takes
PAYLOAD = 6          # x, y, w, l, cos(yaw), sin(yaw)


def _payload(boxes):
    """(..., n, 7) -> (..., n, 6) [x, y, w, l, cos(yaw), sin(yaw)]."""
    yaw = boxes[..., 6]
    return torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 3],
                        boxes[..., 4], torch.cos(yaw), torch.sin(yaw)],
                       dim=-1)


def _pad_tiles(pay, n, block):
    """Pad the box axis (dim -2) of a payload to whole tiles with boxes of
    ones (the JAX kernel's filler: every field 1, so cos = sin = cos(1),
    sin(1))."""
    n_pad = -(-n // block) * block
    if n_pad == n:
        return pay
    ones = torch.ones(pay.shape[:-2] + (n_pad - n, 7), dtype=pay.dtype,
                      device=pay.device)
    return torch.cat([pay, _payload(ones)], dim=-2)


def _tree_sum(v):
    """(..., T, b) -> (..., T) sums over the last dim as a halving tree over
    the tile padded with zeros to a power of two: element i adds element
    i + half, half = p/2, ..., 1 — the kernel's shared-memory reduction."""
    b = v.shape[-1]
    p = 1
    while p < b:
        p *= 2
    if p != b:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (p - b,))], dim=-1)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _corners(xs, ys, ws, ls, c, s):
    """CCW corner list [(cx, cy) x 4] of the JAX kernel's ``_corners``."""
    out = []
    for lx_sign, ly_sign in ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5),
                             (0.5, -0.5)):
        lx = lx_sign * ls
        ly = ly_sign * ws
        out.append((xs + c * lx - s * ly, ys + s * lx + c * ly))
    return out


def _half_integral(poly, clip):
    """Sum over ``poly``'s edges of int x dy restricted to the inside of the
    convex ``clip`` (the JAX kernel's ``_half_integral``, op for op)."""
    planes = []
    for h in range(4):
        ax, ay = clip[h]
        bx, by = clip[(h + 1) % 4]
        ex, ey = bx - ax, by - ay
        nx, ny = ey, -ex
        planes.append((nx, ny, nx * ax + ny * ay))
    area = None
    for e in range(4):
        p1x, p1y = poly[e]
        p2x, p2y = poly[(e + 1) % 4]
        dx, dy = p2x - p1x, p2y - p1y
        t_lo = t_hi = None
        for nx, ny, c in planes:
            f0 = p1x * nx + p1y * ny - c
            nd = dx * nx + dy * ny
            parallel = torch.abs(nd) <= _EPS
            t_star = -f0 / torch.where(parallel, 1.0, nd)
            ok = f0 <= _EPS
            hi_c = torch.where(parallel, torch.where(ok, _BIG, -_BIG),
                               torch.where(nd > 0, t_star, _BIG))
            lo_c = torch.where(parallel, torch.where(ok, -_BIG, _BIG),
                               torch.where(nd < 0, t_star, -_BIG))
            t_hi = hi_c if t_hi is None else torch.minimum(t_hi, hi_c)
            t_lo = lo_c if t_lo is None else torch.maximum(t_lo, lo_c)
        t_hi = torch.clamp(torch.clamp(t_hi, max=1.0), min=0.0)
        t_lo = torch.minimum(torch.clamp(t_lo, min=0.0), t_hi)
        span = t_hi - t_lo
        sq = 0.5 * (t_hi * t_hi - t_lo * t_lo)
        contrib = dy * (p1x * span + dx * sq)
        area = contrib if area is None else area + contrib
    return area


def _blocks(n, m, block_i, block_j):
    return min(block_i, n), min(block_j, m)


def rotated_iou_bev_tiled(boxes1, boxes2, block_i: int = 128,
                          block_j: int = 128):
    """K7. boxes1 (N, 7), boxes2 (M, 7) f32 -> (N, M) f32 IoU, or batched
    (B, N, 7), (B, M, 7) -> (B, N, M). Blocks clamp to N and M as in the
    JAX wrapper; the CUDA kernel takes blocks of at most ``MAX_BLOCK``."""
    batched = boxes1.dim() == 3
    if boxes1.dim() not in (2, 3) or boxes2.dim() != boxes1.dim() \
            or boxes1.shape[-1] != 7 or boxes2.shape[-1] != 7 \
            or (batched and boxes1.shape[0] != boxes2.shape[0]):
        raise ValueError(f"rotated_iou_bev_tiled wants (N, 7) x (M, 7) or "
                         f"(B, N, 7) x (B, M, 7), got {tuple(boxes1.shape)}"
                         f" x {tuple(boxes2.shape)}")
    if boxes1.device.type == "cpu":
        return rotated_iou_bev_tiled_plain(boxes1, boxes2, block_i, block_j)
    if boxes1.dtype != torch.float32 or boxes2.dtype != torch.float32 \
            or boxes2.device != boxes1.device:
        raise TypeError(f"rotated_iou_bev_tiled wants float32 boxes on one "
                        f"device, got {boxes1.dtype} on {boxes1.device} and "
                        f"{boxes2.dtype} on {boxes2.device}")
    # the kernel reads both through their strides (a 2-D input is one
    # sample, its sample stride unused), so no view or copy is dispatched
    if batched:
        B, n, m = boxes1.shape[0], boxes1.shape[1], boxes2.shape[1]
        strides = boxes1.stride() + boxes2.stride()
        shape = (B, n, m)
    else:
        B, n, m = 1, boxes1.shape[0], boxes2.shape[0]
        strides = (0,) + boxes1.stride() + (0,) + boxes2.stride()
        shape = (n, m)
    out = torch.empty(shape, dtype=torch.float32, device=boxes1.device)
    if B == 0 or n == 0 or m == 0:
        return out
    bi, bj = _blocks(n, m, block_i, block_j)
    if bi > MAX_BLOCK or bj > MAX_BLOCK or bi < 1 or bj < 1:
        raise ValueError(f"the CUDA kernel takes blocks of 1..{MAX_BLOCK}, "
                         f"got ({bi}, {bj})")
    if max(strides) >= 2 ** 31:
        raise ValueError(f"rotated_iou_bev_tiled: strides {strides} do not "
                         f"fit the kernel's 32-bit ints")
    _build.launch("iou_tiled", "iou_tiled", "pppiiiiiiiiiii", boxes1,
                  boxes2, out, B, n, m, bi, bj, *strides)
    return out


def rotated_iou_bev_tiled_plain(boxes1, boxes2, block_i: int = 128,
                                block_j: int = 128):
    """Plain PyTorch version of :func:`rotated_iou_bev_tiled`: the JAX
    kernel's per-tile arithmetic over every tile at once (tiles as extra
    broadcast dims)."""
    batched = boxes1.dim() == 3
    b1 = boxes1 if batched else boxes1[None]
    b2 = boxes2 if batched else boxes2[None]
    B, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
    if B == 0 or n == 0 or m == 0:
        out = b1.new_zeros((B, n, m))
        return out if batched else out[0]
    bi, bj = _blocks(n, m, block_i, block_j)
    p1 = _pad_tiles(_payload(b1.float()), n, bi)      # (B, Ti*bi, 6)
    p2 = _pad_tiles(_payload(b2.float()), m, bj)
    ti, tj = p1.shape[1] // bi, p2.shape[1] // bj
    r = p1.reshape(B, ti, 1, bi, 1, PAYLOAD)          # tile rows
    k = p2.reshape(B, 1, tj, 1, bj, PAYLOAD)          # tile columns
    sx1 = _tree_sum(p1[..., 0].reshape(B, ti, bi)) / bi      # (B, ti)
    sy1 = _tree_sum(p1[..., 1].reshape(B, ti, bi)) / bi
    sx2 = _tree_sum(p2[..., 0].reshape(B, tj, bj)) / bj
    sy2 = _tree_sum(p2[..., 1].reshape(B, tj, bj)) / bj
    mx = (0.5 * (sx1[:, :, None] + sx2[:, None, :]))[..., None, None]
    my = (0.5 * (sy1[:, :, None] + sy2[:, None, :]))[..., None, None]

    xi, yi, wi, li, ci, si = (r[..., q] for q in range(PAYLOAD))
    xj, yj, wj, lj, cj, sj = (k[..., q] for q in range(PAYLOAD))
    ca = _corners(xi - mx, yi - my, wi, li, ci, si)
    cb = _corners(xj - mx, yj - my, wj, lj, cj, sj)
    inter = _half_integral(ca, cb) + _half_integral(cb, ca)
    inter = torch.clamp(inter, min=0.0)
    dx = xi - xj
    dy = yi - yj
    rr = 0.5 * (torch.sqrt(wi * wi + li * li) + torch.sqrt(wj * wj + lj * lj))
    inter = torch.where(dx * dx + dy * dy > rr * rr, 0.0, inter)
    ai = wi * li
    aj = wj * lj
    inter = torch.minimum(inter, torch.minimum(ai, aj))
    union = torch.clamp(ai + aj - inter, min=_EPS)
    iou = torch.clamp(inter / union, 0.0, 1.0)     # (B, ti, tj, bi, bj)
    iou = iou.permute(0, 1, 3, 2, 4).reshape(B, ti * bi, tj * bj)[:, :n, :m]
    return iou if batched else iou[0]
