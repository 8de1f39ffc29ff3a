"""Pillarization: points -> (pillar features, coords, masks), static shapes.

Port of ``tpu_pillars/ops/voxelize.py``: the plain, canonical spec of the
front end, which the kernels of the fused path are held to.

Canonical semantics:

  1. A point is valid if its index < num_points and it falls inside the
     detection range (after floor-binning, its cell is inside the grid).
  2. pillar_id = row * grid_w + col, row from y, col from x.
  3. Pillars are ordered by ascending pillar_id; the first `max_pillars`
     pillars by id are kept (deterministic overflow policy).
  4. Within a pillar, points keep their original input order; the first
     `max_points_per_pillar` are kept.
  5. Each kept point is decorated to D = raw + 5 features:
     (x, y, z, intensity[, dt], xc, yc, zc, xp, yp) where (xc, yc, zc) is the
     offset to the arithmetic mean of the pillar's kept points and (xp, yp)
     the offset to the pillar's cell center. Padded slots are all-zero.

The pillar id is ``floor((x - x_min) / voxel)`` in f32 with a correctly
rounded division — on the card as on the CPU, at any pitch (no fast math
anywhere, and no division turned into a multiply by the reciprocal).

:func:`pillarize` is one sweep, :func:`pillarize_batch` a batch; both are
plain PyTorch. ``ops.emit.pillarize_auto`` / ``pillarize_batch_auto`` run
K1 on a CUDA tensor and these on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pillars_torch.config import PillarsConfig


class PillarBatch(NamedTuple):
    """Static-shape pillarized sweeps, leading batch dim B (none for the
    one sweep of :func:`pillarize`).

    features: (B, P, N, D) decorated per-point features, zero-padded
    mask:     (B, P, N) bool — valid point slots
    coords:   (B, P, 2) int32 — (row, col) BEV cell per pillar (0 if invalid)
    pillar_mask: (B, P) bool — valid pillars
    """

    features: torch.Tensor
    mask: torch.Tensor
    coords: torch.Tensor
    pillar_mask: torch.Tensor


def pillar_ids(points: torch.Tensor, num_points: torch.Tensor,
               config: PillarsConfig) -> torch.Tensor:
    """(B, M, F) points, (B,) counts -> (B, M) int32 pillar id, H*W for
    invalid points (rules 1-2)."""
    W, H = config.grid_w, config.grid_h
    B, M, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    alive = (torch.arange(M, device=points.device)[None, :]
             < num_points.to(points.device)[:, None])
    # the pitch as a device tensor: CUDA divides by a host scalar as a
    # multiply by its f32 reciprocal, which misplaces points at cell
    # boundaries unless the pitch is a power of two; by a tensor it divides
    # correctly rounded, as the CPU does
    col = torch.floor((x - config.x_min) / x.new_full((), config.voxel_x)
                      ).to(torch.int32)
    row = torch.floor((y - config.y_min) / y.new_full((), config.voxel_y)
                      ).to(torch.int32)
    in_range = ((col >= 0) & (col < W) & (row >= 0) & (row < H)
                & (z >= config.z_min) & (z <= config.z_max))
    valid = alive & in_range
    return torch.where(valid, row * W + col,
                       torch.full_like(row, H * W)).to(torch.int32)


def sort_points_by_pillar(points: torch.Tensor, num_points: torch.Tensor,
                          config: PillarsConfig):
    """(B, M, F) points -> (gid_sorted (B, M) int32 ascending per sample
    with H*W as the invalid sentinel, pts_sorted (B, M, F)).

    A stable ``torch.sort`` of the int32 pillar id, then one payload gather —
    the counterpart of the XLA multi-operand ``lax.sort`` the JAX package
    uses (a library sort, as the JAX package left the sort to XLA)."""
    pid = pillar_ids(points, num_points, config)
    gid, order = torch.sort(pid, dim=1, stable=True)
    F = points.shape[-1]
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, F))
    return gid, pts


def pillarize(points: torch.Tensor, num_points,
              config: PillarsConfig) -> PillarBatch:
    """One sweep: points (M, F), num_points a scalar (int, or a 0-d or
    1-element tensor) -> PillarBatch without a batch dim: row 0 of
    :func:`pillarize_batch` on a batch of one (the JAX ``pillarize``'s
    values; the batch's rows are independent)."""
    n = torch.as_tensor(num_points, device=points.device).reshape(1)
    return PillarBatch(*(x[0] for x in pillarize_batch(points[None], n,
                                                       config)))


def pillarize_batch(points: torch.Tensor, num_points: torch.Tensor,
                    config: PillarsConfig) -> PillarBatch:
    """(B, M, F) points -> PillarBatch: one stable sort of sample-offset
    pillar ids, segment structure by cumulative sums/maxima, masked stores
    (rules 1-5)."""
    P = config.max_pillars
    N = config.max_points_per_pillar
    W, H = config.grid_w, config.grid_h
    B, M, F = points.shape
    HW = H * W
    dev = points.device

    pid = pillar_ids(points, num_points, config).long()
    gid = (torch.arange(B, device=dev)[:, None] * (HW + 1) + pid).reshape(-1)
    s, order = torch.sort(gid, stable=True)
    idx = torch.arange(B * M, device=dev)

    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         s[1:] != s[:-1]])
    sample_id = s // (HW + 1)
    pid_sorted = s % (HW + 1)
    seg_valid = pid_sorted < HW
    first = new_seg & seg_valid

    # pillar ordinal within its own sample: global ordinal minus the count
    # of valid pillars belonging to earlier samples
    fi = first.long()
    cf_excl = torch.cumsum(fi, 0) - fi
    sample_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              sample_id[1:] != sample_id[:-1]])
    base = torch.cummax(torch.where(sample_first, cf_excl, -1), 0).values
    pord_local = (cf_excl + fi - 1) - base
    seg_start = torch.cummax(torch.where(new_seg, idx, -1), 0).values
    rank = idx - seg_start

    keep = seg_valid & (rank < N) & (pord_local < P)
    slot = (sample_id * P + pord_local) * N + rank
    pts_sorted = points.reshape(B * M, F)[order]
    raw = torch.zeros((B * P * N, F), dtype=points.dtype, device=dev)
    raw[slot[keep]] = pts_sorted[keep]
    raw = raw.reshape(B, P, N, F)
    mask = torch.zeros(B * P * N, dtype=torch.bool, device=dev)
    mask[slot[keep]] = True
    mask = mask.reshape(B, P, N)

    pkeep = first & (pord_local < P)
    pslot = (sample_id * P + pord_local)[pkeep]
    pid_per = torch.zeros(B * P, dtype=torch.int32, device=dev)
    pid_per[pslot] = pid_sorted[pkeep].to(torch.int32)
    pillar_mask = torch.zeros(B * P, dtype=torch.bool, device=dev)
    pillar_mask[pslot] = True
    pid_per = pid_per.reshape(B, P)
    pillar_mask = pillar_mask.reshape(B, P)
    coords = (torch.stack([pid_per // W, pid_per % W], dim=-1)
              * pillar_mask[..., None])

    features = decorate(raw, mask, coords, config)
    return PillarBatch(features, mask, coords.to(torch.int32), pillar_mask)


def decorate(raw, mask, coords, config: PillarsConfig):
    """Append (xc, yc, zc) mean offsets and (xp, yp) cell-center offsets.

    raw: (..., P, N, F); mask: (..., P, N); coords: (..., P, 2)
    -> (..., P, N, F + 5). The point sums run in slot order."""
    fmask = mask[..., None].to(raw.dtype)
    count = torch.clamp(fmask.sum(dim=-2), min=1.0)              # (..., P, 1)
    masked = raw[..., :3] * fmask
    total = masked[..., 0, :]
    for j in range(1, raw.shape[-2]):
        total = total + masked[..., j, :]
    mean_xyz = total / count                                      # (..., P, 3)
    off_mean = raw[..., :3] - mean_xyz[..., None, :]

    cx = config.x_min + (coords[..., 1].to(raw.dtype) + 0.5) * config.voxel_x
    cy = config.y_min + (coords[..., 0].to(raw.dtype) + 0.5) * config.voxel_y
    off_center = torch.stack(
        [raw[..., 0] - cx[..., None], raw[..., 1] - cy[..., None]], dim=-1)
    out = torch.cat([raw, off_mean, off_center], dim=-1)
    return out * fmask


def scatter_to_bev(pillar_features, coords, pillar_mask,
                   config: PillarsConfig):
    """(B, P, C) pillar vectors -> (B, H, W, C) canvas; zero elsewhere."""
    H, W = config.grid_h, config.grid_w
    B, P, C = pillar_features.shape
    cell = coords[..., 0].long() * W + coords[..., 1].long()
    flat = cell + torch.arange(B, device=cell.device)[:, None] * (H * W)
    canvas = torch.zeros((B * H * W, C), dtype=pillar_features.dtype,
                         device=pillar_features.device)
    canvas[flat[pillar_mask]] = pillar_features[pillar_mask]
    return canvas.reshape(B, H, W, C)
