"""K8 binning: the sort-free pillarizer.

Port of ``tpu_pillars/ops/binning_pallas.py`` (``rank_and_hist``,
``pillarize_batch_binned``). What the canonical spec (``ops/voxelize.py``)
needs from the sort is a counting problem:

    rank(i)  = #{j < i : cell(j) == cell(i)}       (first-N tie-break)
    count(c) = #points in cell c                   (mask, pillar order)

Both only ever meet N (max points per pillar, <= 32), so both saturate at
64. :func:`rank_and_hist` returns rank = min(exact rank, 64) — exact below
64, 64 at and above, within the TPU kernel's "exact below 64, >= 64" — and
hist = min(count, 64). On a CPU tensor it runs :func:`rank_and_hist_plain`;
on a CUDA tensor it makes one launch of ``csrc/binning.cu`` into
``torch.empty`` and runs no other torch op. The two agree bit for bit.

What bounds the kernel is bytes: rows and cols read, rank and the histogram
written once. The first port walked each sample's chunks in order on one
block (8 of 132 SMs at batch 8) with a quadratic comparison per chunk. The
rank depends on input order, and random L2 traffic (atomics, gathers,
scatters per point) is what a counting sort by cell would spend its time
on, so the kernel partitions the points stably into bands of consecutive
cells over (tile, sample) blocks and then ranks each band in shared
memory, in index order, with one block of 8 warps per (band, sample)
(:func:`rank_by_bands_plain` is that route in plain PyTorch). The design
notes are in the ``.cu`` header.

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


BAND_WARPS = 8           # warps that share a band in the kernel
MAX_BANDS = 4096         # bands a sample, at most
MAX_CELLS = MAX_BANDS << 12


def band_shift(cells: int) -> int:
    """The kernel's bands hold 2^shift cells: the least shift of 10, 11, 12
    that keeps a sample's bands at most ``MAX_BANDS``."""
    for shift in (10, 11, 12):
        if -(-cells >> shift) <= MAX_BANDS:
            return shift
    raise ValueError(f"rank_and_hist: {cells} cells a sample; the kernel "
                     f"takes at most {MAX_CELLS}")


def scratch_words(batch: int, m: int, h_bins: int, w_pad: int) -> int:
    """int32 words of scratch :func:`rank_and_hist` hands its kernel: the
    points of each (band, tile of 1,024 points), then their first slots,
    the bands' totals, and B * M (index, cell) pairs in band order (9.2 MB
    at the full config and batch 8)."""
    bands = -(-(h_bins * w_pad) >> band_shift(h_bins * w_pad))
    tiles = -(-m // 1024)
    return (batch * bands * (tiles + 1) + 3) // 4 * 4 + 2 * batch * m


def rank_and_hist(rows: torch.Tensor, cols: torch.Tensor, h_bins: int,
                  w_pad: int):
    """rows, cols (B, M) int32 (a row outside [0, h_bins) or a col outside
    [0, w_pad) marks an invalid point) -> (rank (B, M) int32: min(count of
    earlier points of the sample in the same cell, 64), 0 for invalid
    points; hist (B, h_bins, w_pad) f32: min(points per cell, 64)). On the
    card it allocates :func:`scratch_words` int32 words of scratch and
    takes at most ``MAX_CELLS`` cells a sample."""
    _check(rows, cols)
    if rows.device.type == "cpu":
        return rank_and_hist_plain(rows, cols, h_bins, w_pad)
    B, M = rows.shape
    words = scratch_words(B, M, h_bins, w_pad)   # refuses too many cells
    if words >= 2**31:
        raise ValueError(f"rank_and_hist: (B, M) {(B, M)} and {h_bins} x "
                         f"{w_pad} cells need more scratch than one launch "
                         f"can address")
    r, c = rows.contiguous(), cols.contiguous()
    dev = r.device
    rank = torch.empty((B, M), dtype=torch.int32, device=dev)
    hist = torch.empty((B, h_bins, w_pad), dtype=torch.float32, device=dev)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    _build.launch("binning", "rank_and_hist", "pppppiiiii", r, c, rank, hist,
                  scratch, words, B, M, h_bins, w_pad)
    return rank, hist


def rank_by_bands_plain(rows: torch.Tensor, cols: torch.Tensor,
                        h_bins: int, w_pad: int):
    """K8's route in plain PyTorch, the same (rank, hist) as
    :func:`rank_and_hist`: each band of 2^shift cells takes its points in
    index order (the kernel's stable partition) and splits them into
    ``BAND_WARPS`` runs of equal length, rounded up to 32; a point's rank
    is its cell's points in the earlier runs plus those before it in its
    own run, at most 64, and the band's counts give the histogram."""
    _check(rows, cols)
    B, M = rows.shape
    cells = h_bins * w_pad
    shift = band_shift(cells)
    valid = (rows >= 0) & (rows < h_bins) & (cols >= 0) & (cols < w_pad)
    cell = torch.where(valid, rows.long() * w_pad + cols.long(), -1)
    rank = torch.zeros((B, M), dtype=torch.int32)
    hist = torch.zeros((B, cells), dtype=torch.float32)
    for b in range(B):
        band = torch.where(valid[b], cell[b] >> shift, -1)
        for k in torch.unique(band[band >= 0]).tolist():
            members = torch.nonzero(band == k).flatten()      # index order
            local = cell[b, members] - (k << shift)
            per = -(-(-(-len(members) // BAND_WARPS)) // 32) * 32
            before = torch.zeros(1 << shift, dtype=torch.long)
            for w in range(BAND_WARPS):
                run = local[w * per:(w + 1) * per]
                earlier = (run[None, :] == run[:, None]).tril(-1).sum(1)
                rank[b, members[w * per:(w + 1) * per]] = torch.clamp(
                    before[run] + earlier, max=CAP).to(torch.int32)
                before += torch.bincount(run, minlength=1 << shift)
            lo = k << shift
            hist[b, lo:lo + (1 << shift)] = torch.clamp(
                before, max=CAP)[:cells - lo].to(torch.float32)
    return rank, hist.reshape(B, h_bins, w_pad)


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
