"""K11 streaming serving front end: sorted points -> BEV canvas in one
pass, with no pillar table. Port of ``tpu_pillars/ops/stream_pfn.py``.

After the stable sort by pillar id, each pillar's points are one CONTIGUOUS
run, and only its first N (``max_points_per_pillar``) points are kept, so
every value that shapes a pillar lies within N rows of its run's start.
The canvas is the fused path's algebra (``ops/fused_pfn.py``) reduced per
run instead of per table row:

    canvas[b, gid // W, gid % W] = relu(max_{kept j} W_eff^T r'_j + t)

at each of the first P runs of a sample (the pillar budget, P =
``max_pillars``), zeros elsewhere, with r' the cell-centred point and t the
decoration bias from the run's kept-point sums (fold_decoration's w_dec).
Ids ascend, so the budget is a cutoff: a run is kept when its id is at
most the id of the sample's P-th run (:func:`stream_budget_cutoff_plain`).

On a CUDA tensor :func:`stream_canvas_from_sorted` makes one launch of
``csrc/stream_pfn.cu`` into ``torch.empty`` and runs no other torch op:
its C entry finds each sample's cutoff and each tile's first row in two
small passes over the ids, then writes every canvas cell once, in canvas
order, in tiles of ``STREAM_TILE_CELLS`` cells (K3's design), each
thread computing the elements it stores. What bounds it is the canvas
write; the design notes are in the ``.cu`` header. The TPU kernel's ring
window, bf16 splits, one-hot matmuls and prefix-doubling ladder are
placement machinery the card does not need. On a CPU tensor it runs
:func:`stream_canvas_from_sorted_plain`, which takes the budget from the
sidecar (:func:`stream_sidecar`, stock torch, as the JAX package leaves it
to XLA: run starts ``gid != gid[j-1]``, their running count, and the row of
the first point of each of the first P runs). Both take the coordinate sums
in slot order (the JAX ladder sums in a tree, so the two packages agree to
rounding, as the JAX stream path agrees with its fused path). Pillar ids
stay int32 throughout (the TPU kernel carried them as f32, exact below
2^24).
"""

from __future__ import annotations

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.bev import scatter_to_bev_plain
from tpu_pillars_torch.ops.fused_pfn import center_points, fold_decoration
from tpu_pillars_torch.ops.voxelize import sort_points_by_pillar

MAX_F = 8            # the kernel keeps a point's features in registers
MAX_N = 32           # kept points per run the kernel takes
STREAM_TILE_CELLS = 64    # canvas cells per block (kTileCells in the .cu)
STREAM_CHUNK_ROWS = 1024  # ids per run-start count (kChunk in the .cu)


def stream_sidecar(gid_sorted, config: PillarsConfig):
    """(B, M) ascending int32 pillar ids (H*W sentinel last) -> start_row
    (B, P) int32: the row of the first point of each of the sample's first
    P runs, -1 past its last run. Run p starts at the first row where the
    running count of run starts reaches p + 1 (one ``searchsorted``)."""
    HW, P = config.grid_h * config.grid_w, config.max_pillars
    gid = gid_sorted.to(torch.int32)
    B, M = gid.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                 device=gid.device), gid[:, :-1]], dim=1)
    start = (gid < HW) & (gid != prev)
    runs = torch.cumsum(start, dim=1)                           # int64
    want = torch.arange(1, P + 1, device=gid.device).expand(B, P)
    row = torch.searchsorted(runs, want.contiguous())
    return torch.where(row < M, row, -1).to(torch.int32)


def stream_budget_cutoff_plain(gid_sorted, config: PillarsConfig):
    """(B, M) ascending int32 pillar ids -> (B,) int32 cutoff: the id of the
    sample's P-th run (P = ``max_pillars``), or H*W - 1 when it has fewer
    runs. A run is among the first P exactly when its id is at most the
    cutoff; the kernel's budget pass computes the same value."""
    HW = config.grid_h * config.grid_w
    gid = gid_sorted.to(torch.int32)
    B, M = gid.shape
    if M == 0:
        return torch.full((B,), HW - 1, dtype=torch.int32, device=gid.device)
    last = stream_sidecar(gid, config)[:, -1]
    at = torch.gather(gid, 1, last.clamp(min=0).long()[:, None])[:, 0]
    return torch.where(last >= 0, at, HW - 1).to(torch.int32)


def _check(gid_sorted, pts_centered, w_eff, w_dec, config: PillarsConfig):
    if gid_sorted.dim() != 2 or pts_centered.dim() != 3 \
            or pts_centered.shape[:2] != gid_sorted.shape:
        raise ValueError(f"stream_canvas_from_sorted wants gid (B, M) and "
                         f"points (B, M, F), got {tuple(gid_sorted.shape)}, "
                         f"{tuple(pts_centered.shape)}")
    F, C = w_eff.shape
    if pts_centered.shape[-1] != F or w_dec.shape != (8, C):
        raise ValueError(f"stream_canvas_from_sorted: points have "
                         f"{pts_centered.shape[-1]} features, w_eff "
                         f"{tuple(w_eff.shape)}, w_dec {tuple(w_dec.shape)}")
    if F > MAX_F or config.max_points_per_pillar > MAX_N:
        raise ValueError(f"stream_canvas_from_sorted takes F <= {MAX_F} and "
                         f"max_points_per_pillar <= {MAX_N}")


def stream_canvas_from_sorted(gid_sorted, pts_centered, w_eff, w_dec,
                              config: PillarsConfig):
    """K11. (B, M) int32 ascending pillar ids (H*W sentinel) + (B, M, F)
    CELL-CENTRED sorted points + :func:`fold_decoration` weights (w_eff
    (F, C), w_dec (8, C)) -> (B, H, W, C) f32 canvas."""
    _check(gid_sorted, pts_centered, w_eff, w_dec, config)
    if gid_sorted.device.type == "cpu":
        return stream_canvas_from_sorted_plain(gid_sorted, pts_centered,
                                               w_eff, w_dec, config)
    dev = gid_sorted.device
    for name, t in (("points", pts_centered), ("w_eff", w_eff),
                    ("w_dec", w_dec)):
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"stream_canvas_from_sorted: {name} must be "
                            f"float32 on {dev}, got {t.dtype} on {t.device}")
    if gid_sorted.dtype != torch.int32:
        raise TypeError(f"stream_canvas_from_sorted: gid must be int32, got "
                        f"{gid_sorted.dtype}")
    H, W = config.grid_h, config.grid_w
    B, M = gid_sorted.shape
    F, C = w_eff.shape
    n_chunk = -(-M // STREAM_CHUNK_ROWS)
    n_tiles = -(-(H * W) // STREAM_TILE_CELLS)
    canvas = torch.empty((B, H, W, C), dtype=torch.float32, device=dev)
    # per sample: run-start counts per chunk, each tile's first row, cutoff
    scratch = torch.empty((B * (n_chunk + n_tiles + 2),), dtype=torch.int32,
                          device=dev)
    _build.launch("stream_pfn", "stream_pfn", "ppppppiiiiiiiiffff",
                  gid_sorted.contiguous(), pts_centered.contiguous(),
                  w_eff.contiguous(), w_dec.contiguous(), canvas, scratch, B,
                  M, config.max_pillars, config.max_points_per_pillar, F, C,
                  W, H * W, config.x_min, config.y_min, config.voxel_x,
                  config.voxel_y)
    return canvas


def stream_canvas_from_sorted_plain(gid_sorted, pts_centered, w_eff, w_dec,
                                    config: PillarsConfig):
    """Plain PyTorch version of :func:`stream_canvas_from_sorted`: the kept
    points of the first P runs gathered into a (B, P, N, F) table by their
    slot in the run, then the kernel's arithmetic in its order (products
    summed over F in order, max and coordinate sums over the slots in
    order), then the plain BEV scatter."""
    N, P = config.max_points_per_pillar, config.max_pillars
    W = config.grid_w
    F, C = w_eff.shape
    gid = gid_sorted.to(torch.int32)
    B, M = gid.shape
    dev = gid.device
    start_row = stream_sidecar(gid, config)                     # (B, P)
    has = start_row >= 0
    first = start_row.clamp(min=0).long()
    slot = torch.arange(N, device=dev)
    rows = first[..., None] + slot                              # (B, P, N)
    inside = has[..., None] & (rows < M)
    rows = rows.clamp(max=M - 1)
    g = torch.gather(gid, 1, first)                             # (B, P)
    kept = inside & (torch.gather(gid, 1, rows.reshape(B, -1)).reshape(
        B, P, N) == g[..., None])
    table = torch.gather(pts_centered, 1, rows.reshape(B, -1, 1).expand(
        -1, -1, F)).reshape(B, P, N, F)

    smax = torch.full((B, P, C), float("-inf"), device=dev)
    sums = torch.zeros((B, P, 3), device=dev)
    for n in range(N):
        x = table[:, :, n]
        m = kept[:, :, n, None]
        u = x[..., 0:1] * w_eff[0]
        for f in range(1, F):
            u = u + x[..., f:f + 1] * w_eff[f]
        smax = torch.where(m, torch.maximum(smax, u), smax)
        sums = sums + torch.where(m, x[..., 0:3], 0.0)
    cnt = kept.sum(dim=2, keepdim=True).to(torch.float32)

    col = (g % W).to(torch.float32)[..., None]
    row = (g // W).to(torch.float32)[..., None]
    cx = config.x_min + (col + 0.5) * config.voxel_x
    cy = config.y_min + (row + 0.5) * config.voxel_y
    inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
    mx = sums[..., 0:1] * inv_cnt
    my = sums[..., 1:2] * inv_cnt
    mz = sums[..., 2:3] * inv_cnt
    t = (w_dec[5] - mx * w_dec[0] - my * w_dec[1] - mz * w_dec[2]
         - cx * w_dec[3] - cy * w_dec[4])
    feats = torch.clamp(smax + t, min=0.0)
    feats = torch.where(has[..., None], feats, 0.0)
    return scatter_to_bev_plain(feats, g, has, config)


def points_to_canvas_stream(points, num_points, w, b, config: PillarsConfig):
    """The streaming front end: (B, M, F) raw points, (B,) counts + folded
    decorated-space PFN weights (``fused_pfn.fold_bn`` output, as
    ``PointPillars.pfn.folded()`` gives them) -> (B, H, W, C) canvas, the
    canvas that ``Detector.canvas`` returns, so the model's ``wire`` takes
    it unchanged. Drop-in for the fused front end (stable sort, centring,
    K1, K2, K3)."""
    F = points.shape[-1]
    if F != config.num_input_features:
        raise ValueError(f"points have {F} features; config expects "
                         f"{config.num_input_features}")
    gid_s, pts_s = sort_points_by_pillar(points, num_points, config)
    pts_c = center_points(gid_s, pts_s, config)
    w_eff, w_dec = fold_decoration(w, b, config)
    return stream_canvas_from_sorted(gid_s, pts_c, w_eff, w_dec, config)
