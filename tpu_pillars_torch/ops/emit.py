"""K1 emit: sorted points -> flat pillar table + per-pillar meta.

Port of ``tpu_pillars/ops/emit_pallas.py`` (``emit_table_flat``). Inputs are
one sample's points sorted by pillar id (``ops.voxelize.
sort_points_by_pillar``), outputs the flat layout the fused PFN consumes:

  table (B*P, n_pts*F) f32 — row ``b*P + r`` holds pillar r's kept points,
        point ``rank`` at columns ``rank*F + f``; unfilled slots are zero;
  meta  (B*8, P) f32 — rows per sample: 0 kept-point count, 1 pillar id,
        2-4 kept-point x/y/z sums, 5-7 zero.

Pillars are the first ``p_budget`` by id, points the first ``n_pts`` of each
pillar (canonical spec rules 3-4, ``ops/voxelize.py``). Rows past the last
kept pillar are zero. Unlike the TPU kernel the table carries no ``whalf``
row padding and no 128-lane padding.

On a CUDA tensor :func:`emit_table` makes one launch of ``csrc/emit.cu``
into ``torch.empty`` and runs no other torch op. What bounds it is writing
the table and meta once. Ids ascend, so each pillar's points are one
contiguous run of the sorted stream: the C entry counts run starts per
``EMIT_CHUNK_ROWS`` ids, then gives each chunk's runs their ordinals and
records each kept run's first row (:func:`emit_runs_plain` is that rule in
plain PyTorch), then writes every table row and meta column once, one warp
per row, spread over (tile of rows, sample) blocks. The design notes are in
the ``.cu`` header. On a CPU tensor it runs :func:`emit_table_plain`. The
two agree bit for bit: the sums are taken in rank order on both sides.

The classic front end (``emit_pallas.py`` ``emit_pillar_table``,
``pillarize_batch_emit``) feeds K1 the raw sorted points and builds the
decorated ``PillarBatch`` from its table: :func:`pillarize_batch_emit`.
:func:`pillarize_auto` (one sweep) and :func:`pillarize_batch_auto` pick by
the points' device, as the JAX functions pick by backend: K1 on a CUDA
tensor, the plain ``ops.voxelize`` pillarizers on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.voxelize import (
    PillarBatch, decorate, pillarize, pillarize_batch, sort_points_by_pillar,
)

META_ROWS = 8
EMIT_CHUNK_ROWS = 1024  # ids per run-start count (kChunk in the .cu)


def _check(gid, pts):
    if gid.dtype != torch.int32 or pts.dtype != torch.float32:
        raise TypeError(f"emit_table wants int32 gid and float32 points, "
                        f"got {gid.dtype} and {pts.dtype}")
    if gid.dim() != 2 or pts.dim() != 3 or pts.shape[:2] != gid.shape:
        raise ValueError(f"emit_table wants gid (B, M) and points (B, M, F); "
                         f"got {tuple(gid.shape)} and {tuple(pts.shape)}")
    if gid.device != pts.device:
        raise ValueError("gid and points lie on different devices")


def emit_table(gid_sorted: torch.Tensor, pts_sorted: torch.Tensor,
               n_pts: int, p_budget: int, hw: int):
    """gid_sorted (B, M) int32 ascending per sample (``hw`` marks invalid
    points), pts_sorted (B, M, F) f32 -> (table, meta), see module
    docstring. The op ``tpu_pillars::emit_table`` (``_build.kernel_op``):
    :func:`emit_table_cuda` on a CUDA tensor, :func:`emit_table_plain` on
    a CPU tensor."""
    _check(gid_sorted, pts_sorted)
    return _EMIT_TABLE(gid_sorted, pts_sorted, n_pts, p_budget, hw)


def emit_table_cuda(gid_sorted: torch.Tensor, pts_sorted: torch.Tensor,
                    n_pts: int, p_budget: int, hw: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's launch, the CUDA implementation of ``tpu_pillars::emit_table``:
    one launch into ``torch.empty``."""
    B, M, F = pts_sorted.shape
    dev = gid_sorted.device
    table = torch.empty((B * p_budget, n_pts * F), dtype=torch.float32,
                        device=dev)
    meta = torch.empty((B * META_ROWS, p_budget), dtype=torch.float32,
                       device=dev)
    # per sample: run-start counts per chunk, kept pillars, first rows
    scratch = torch.empty((B * (-(-M // EMIT_CHUNK_ROWS) + p_budget + 2),),
                          dtype=torch.int32, device=dev)
    _build.launch("emit", "emit_table", "pppppiiiiii",
                  gid_sorted.contiguous(), pts_sorted.contiguous(), table,
                  meta, scratch, B, M, F, n_pts, p_budget, hw)
    return table, meta


def _emit_table_fake(gid_sorted, pts_sorted, n_pts, p_budget, hw):
    B, _, F = pts_sorted.shape
    return (pts_sorted.new_empty((B * p_budget, n_pts * F)),
            pts_sorted.new_empty((B * META_ROWS, p_budget)))


def emit_table_plain(gid_sorted: torch.Tensor, pts_sorted: torch.Tensor,
                     n_pts: int, p_budget: int, hw: int):
    """Plain PyTorch version of :func:`emit_table` (same outputs, bit for
    bit): segment structure by cumulative sums/maxima, stores by masked
    index assignment, sums in rank order."""
    _check(gid_sorted, pts_sorted)
    B, M, F = pts_sorted.shape
    dev = gid_sorted.device
    gid = gid_sorted.long()
    idx = torch.arange(M, device=dev).expand(B, M)
    valid = gid < hw
    prev = torch.cat([torch.full((B, 1), -1, device=dev, dtype=gid.dtype),
                      gid[:, :-1]], dim=1)
    nxt = torch.cat([gid[:, 1:],
                     torch.full((B, 1), hw, device=dev, dtype=gid.dtype)],
                    dim=1)
    new_seg = gid != prev
    first = valid & new_seg
    ordinal = torch.cumsum(first.long(), dim=1) - 1
    seg_start = torch.cummax(torch.where(new_seg, idx, -1), dim=1).values
    rank = idx - seg_start
    in_budget = valid & (ordinal < p_budget)
    row = torch.arange(B, device=dev)[:, None] * p_budget + ordinal

    table = torch.zeros((B * p_budget * n_pts, F), dtype=torch.float32,
                        device=dev)
    keep = in_budget & (rank < n_pts)
    table[(row * n_pts + rank)[keep]] = pts_sorted[keep]
    table = table.reshape(B * p_budget, n_pts * F)

    meta = torch.zeros((B, META_ROWS, p_budget), dtype=torch.float32,
                       device=dev)
    last = in_budget & (nxt != gid)
    b_of = torch.arange(B, device=dev)[:, None].expand(B, M)[last]
    o_of = ordinal[last]
    meta[b_of, 0, o_of] = torch.clamp(rank[last] + 1, max=n_pts).float()
    meta[b_of, 1, o_of] = gid[last].float()

    # kept x/y/z sums in rank order (bit-equal to the kernel's per-thread
    # loop: adding an exact 0.0 for slots past the count changes nothing)
    cnt = meta[:, 0].reshape(B * p_budget, 1)
    rows = table.reshape(B * p_budget, n_pts, F)
    sums = torch.zeros((B * p_budget, 3), dtype=torch.float32, device=dev)
    for j in range(n_pts):
        sums = sums + torch.where(j < cnt, rows[:, j, :3], 0.0)
    meta[:, 2:5] = sums.reshape(B, p_budget, 3).transpose(1, 2)
    return table, meta.reshape(B * META_ROWS, p_budget)


_EMIT_TABLE = _build.kernel_op("emit_table", emit_table_cuda,
                               emit_table_plain, _emit_table_fake)


def emit_runs_plain(gid_sorted: torch.Tensor, p_budget: int, hw: int):
    """The run structure the kernel's first two passes record, in plain
    PyTorch: (B, M) int32 ids ascending per sample (``hw`` marks invalid
    points) -> (starts (B, P + 1) int32, kept (B,) int32). ``kept`` is
    min(runs, P); row r < kept of the table holds the sample's points
    ``starts[r]`` .. ``starts[r] + min(starts[r + 1] - starts[r], n_pts)``
    (runs are contiguous, so run r ends where run r + 1 starts, or at the
    first invalid point); ``starts[kept]`` is that end of the last kept
    run, and entries past it are -1 (the kernel leaves them unwritten)."""
    gid = gid_sorted.long()
    B, M = gid.shape
    dev = gid.device
    valid = gid < hw
    prev = torch.cat([torch.full((B, 1), -1, device=dev, dtype=gid.dtype),
                      gid[:, :-1]], dim=1)
    first = valid & (gid != prev)
    n_runs = first.sum(dim=1)
    kept = torch.clamp(n_runs, max=p_budget)
    ordinal = torch.cumsum(first.long(), dim=1) - 1
    idx = torch.arange(M, device=dev).expand(B, M)
    starts = torch.full((B, p_budget + 1), -1, dtype=torch.long, device=dev)
    # run r's first row for r <= P (run P's start ends run P - 1) ...
    at = first & (ordinal <= p_budget)
    starts[torch.arange(B, device=dev)[:, None].expand(B, M)[at],
           ordinal[at]] = idx[at]
    # ... and one past the last valid point where the sample has 1 to P
    n_valid = valid.sum(dim=1)
    few = (n_runs > 0) & (n_runs <= p_budget)
    starts[torch.arange(B, device=dev)[few], n_runs[few]] = n_valid[few]
    return starts.to(torch.int32), kept.to(torch.int32)


def emit_pillar_table(gid_sorted: torch.Tensor, pts_sorted: torch.Tensor,
                      n_pts: int, p_budget: int, hw: int):
    """:func:`emit_table` reshaped: table (B, P, n_pts, F) f32, meta
    (B, 8, P) f32 (row 0 kept-point count, row 1 pillar id, rows 2-4 kept
    x/y/z sums). Kept as its own function only so that the name matches the
    reference's."""
    B, _, F = pts_sorted.shape
    table, meta = emit_table(gid_sorted, pts_sorted, n_pts, p_budget, hw)
    return (table.reshape(B, p_budget, n_pts, F),
            meta.reshape(B, META_ROWS, p_budget))


def pillarize_batch_emit(points: torch.Tensor, num_points: torch.Tensor,
                         config: PillarsConfig) -> PillarBatch:
    """Drop-in for ``ops.voxelize.pillarize_batch`` built on K1: the stable
    sort, K1 on the raw sorted points, then the masks, coords and
    ``decorate`` from the table. Bit-identical ``PillarBatch`` fields; the
    pillar ids come out of K1's f32 meta, exact because H*W < 2^24, and
    masked pillars get zero coords."""
    P = config.max_pillars
    N = config.max_points_per_pillar
    W = config.grid_w
    gid_s, pts_s = sort_points_by_pillar(points, num_points, config)
    raw, meta = emit_pillar_table(gid_s, pts_s, N, P,
                                  config.grid_h * config.grid_w)
    cnt = meta[:, 0]
    pid_per = meta[:, 1].to(torch.int32)
    pillar_mask = cnt > 0.0
    mask = (torch.arange(N, device=points.device)[None, None, :]
            < cnt.to(torch.int32)[:, :, None])
    coords = (torch.stack([pid_per // W, pid_per % W], dim=-1)
              * pillar_mask[..., None]).to(torch.int32)
    features = decorate(raw, mask, coords, config)
    return PillarBatch(features, mask, coords, pillar_mask)


def pillarize_auto(points: torch.Tensor, num_points,
                   config: PillarsConfig) -> PillarBatch:
    """One sweep, points (M, F) and a 0-d or 1-element count -> PillarBatch
    without a batch dim: on a CUDA tensor :func:`pillarize_batch_emit` (K1)
    on a batch of one, row 0 returned; on a CPU tensor the plain
    ``ops.voxelize.pillarize``. The two are bit-identical."""
    if points.device.type != "cuda":
        return pillarize(points, num_points, config)
    n = torch.as_tensor(num_points, device=points.device).reshape(-1)
    if n.numel() != 1:
        raise ValueError(f"pillarize_auto takes one sweep's count, got "
                         f"shape {tuple(n.shape)}")
    batch = pillarize_batch_emit(points[None], n, config)
    return PillarBatch(*(x[0] for x in batch))


def pillarize_batch_auto(points: torch.Tensor, num_points: torch.Tensor,
                         config: PillarsConfig) -> PillarBatch:
    """(B, M, F) points, (B,) counts -> PillarBatch: K1
    (:func:`pillarize_batch_emit`) on a CUDA tensor, the plain
    ``ops.voxelize.pillarize_batch`` on a CPU tensor; bit-identical."""
    if points.device.type != "cuda":
        return pillarize_batch(points, num_points, config)
    return pillarize_batch_emit(points, num_points, config)
