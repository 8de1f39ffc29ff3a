"""K8 binning: the sort-free pillarizer.

Port of ``tpu_pillars/ops/binning_pallas.py`` (``rank_and_hist``,
``pillarize_batch_binned``). What the canonical spec (``ops/voxelize.py``)
needs from the sort is a counting problem:

    rank(i)  = #{j < i : cell(j) == cell(i)}       (first-N tie-break)
    count(c) = #points in cell c                   (mask, pillar order)

Both only ever meet N (max points per pillar, <= 32), so both saturate at
64. :func:`rank_and_hist` returns rank = min(exact rank, 64) — exact below
64, 64 at and above, within the TPU kernel's "exact below 64, >= 64" — and
hist = min(count, 64). On a CUDA tensor it launches ``csrc/binning.cu``
(one block walks one sample's chunks in order; integer atomics); on a CPU
tensor it runs :func:`rank_and_hist_plain`. The two agree bit for bit.

:func:`pillarize_batch_binned` builds the ``PillarBatch`` from them,
bit-identical to ``pillarize_batch``; its point and pillar scatters stay
torch indexing, as the JAX package left them to XLA.
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.voxelize import PillarBatch, decorate, pillar_ids

CAP = 64


def _check(rows, cols):
    if rows.dtype != torch.int32 or cols.dtype != torch.int32 \
            or rows.dim() != 2 or cols.shape != rows.shape:
        raise TypeError(f"rank_and_hist wants (B, M) int32 rows and cols, "
                        f"got {rows.dtype} {tuple(rows.shape)} and "
                        f"{cols.dtype} {tuple(cols.shape)}")
    if rows.device != cols.device:
        raise ValueError("rows and cols lie on different devices")


def rank_and_hist(rows: torch.Tensor, cols: torch.Tensor, h_bins: int,
                  w_pad: int):
    """rows, cols (B, M) int32 (a row outside [0, h_bins) or a col outside
    [0, w_pad) marks an invalid point) -> (rank (B, M) int32: min(count of
    earlier points of the sample in the same cell, 64), 0 for invalid
    points; hist (B, h_bins, w_pad) f32: min(points per cell, 64))."""
    _check(rows, cols)
    if rows.device.type == "cpu":
        return rank_and_hist_plain(rows, cols, h_bins, w_pad)
    B, M = rows.shape
    r, c = rows.contiguous(), cols.contiguous()
    rank = torch.empty_like(r)
    count = torch.zeros((B, h_bins, w_pad), dtype=torch.int32,
                        device=r.device)
    hist = torch.empty((B, h_bins, w_pad), dtype=torch.float32,
                       device=r.device)
    _build.launch("binning", "rank_and_hist", "pppppiiii", r, c, rank, count,
                  hist, B, M, h_bins, w_pad)
    return rank, hist


def rank_and_hist_plain(rows: torch.Tensor, cols: torch.Tensor, h_bins: int,
                        w_pad: int):
    """Plain PyTorch version of :func:`rank_and_hist`: exact ranks from a
    stable sort of the cell ids (distance to the segment start), counts
    from a scatter-add, both saturated."""
    _check(rows, cols)
    B, M = rows.shape
    dev = rows.device
    cells = h_bins * w_pad
    valid = (rows >= 0) & (rows < h_bins) & (cols >= 0) & (cols < w_pad)
    cell = torch.where(valid, rows.long() * w_pad + cols.long(), cells)
    s, order = torch.sort(cell, dim=1, stable=True)
    idx = torch.arange(M, device=dev).expand(B, M)
    new_seg = torch.ones((B, M), dtype=torch.bool, device=dev)
    new_seg[:, 1:] = s[:, 1:] != s[:, :-1]
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), dim=1).values
    rank = torch.empty((B, M), dtype=torch.int64, device=dev)
    rank.scatter_(1, order, idx - seg_start)
    rank = torch.where(valid, torch.clamp(rank, max=CAP), 0).to(torch.int32)
    count = torch.zeros((B, cells + 1), dtype=torch.int64, device=dev)
    count.scatter_add_(1, cell, torch.ones_like(cell))
    hist = torch.clamp(count[:, :cells], max=CAP).to(torch.float32)
    return rank, hist.reshape(B, h_bins, w_pad)


def padded_width(config: PillarsConfig) -> int:
    """The histogram's width: grid_w rounded up to 128, as the JAX
    package's, so that the two histograms line up."""
    return ((config.grid_w + 127) // 128) * 128


def cell_rows_cols(points: torch.Tensor, num_points: torch.Tensor,
                   config: PillarsConfig):
    """(B, M, F) points, (B,) counts -> (rows, cols) (B, M) int32, the
    inputs of :func:`rank_and_hist`: a valid point's cell row and column
    (canonical spec rules 1-2), row = grid_h and col = 0 for the rest."""
    W, H = config.grid_w, config.grid_h
    pid = pillar_ids(points, num_points, config)
    valid = pid < H * W
    return torch.where(valid, pid // W, H), torch.where(valid, pid % W, 0)


def pillarize_batch_binned(points: torch.Tensor, num_points: torch.Tensor,
                           config: PillarsConfig) -> PillarBatch:
    """Sort-free drop-in for ``ops.voxelize.pillarize_batch``: same
    canonical semantics, bit-identical ``PillarBatch``; points are scattered
    straight from input order at (sample, pillar ordinal, rank), pillars
    ordered by ascending id from the occupancy histogram."""
    P = config.max_pillars
    N = config.max_points_per_pillar
    W, H = config.grid_w, config.grid_h
    B, _, F = points.shape
    HW = H * W
    dev = points.device

    rows, cols = cell_rows_cols(points, num_points, config)
    valid = rows < H
    rank, hist = rank_and_hist(rows, cols, H, padded_width(config))

    # pillar ordinals: occupied cells in ascending id order
    count = hist[:, :, :W].reshape(B, HW)                    # saturated at 64
    occ = count > 0.0
    ord_excl = torch.cumsum(occ.long(), dim=1) - occ.long()
    pid = torch.where(valid, rows.long() * W + cols.long(), 0)
    ordp = torch.gather(ord_excl, 1, pid)

    keep = valid & (rank < N) & (ordp < P)
    sample = torch.arange(B, device=dev)[:, None]
    dest = (sample * P + ordp) * N + rank
    raw = torch.zeros((B * P * N, F), dtype=points.dtype, device=dev)
    raw[dest[keep]] = points[keep]
    raw = raw.reshape(B, P, N, F)

    # per-pillar table straight from the occupancy grid
    pkeep = occ & (ord_excl < P)
    pslot = (sample * P + ord_excl)[pkeep]
    cell_id = torch.arange(HW, dtype=torch.int32, device=dev).expand(B, HW)
    pid_per = torch.zeros(B * P, dtype=torch.int32, device=dev)
    pid_per[pslot] = cell_id[pkeep]
    cnt_per = torch.zeros(B * P, dtype=torch.float32, device=dev)
    cnt_per[pslot] = count[pkeep]
    pillar_mask = torch.zeros(B * P, dtype=torch.bool, device=dev)
    pillar_mask[pslot] = True
    pid_per = pid_per.reshape(B, P)
    pillar_mask = pillar_mask.reshape(B, P)
    coords = (torch.stack([pid_per // W, pid_per % W], dim=-1)
              * pillar_mask[..., None]).to(torch.int32)
    n_in_pillar = torch.clamp(cnt_per.reshape(B, P), max=float(N)).to(
        torch.int32)
    mask = (torch.arange(N, device=dev)[None, None, :]
            < n_in_pillar[:, :, None])

    features = decorate(raw, mask, coords, config)
    return PillarBatch(features, mask, coords, pillar_mask)
