"""K3 BEV scatter: pillar features -> dense (B, H, W, C) canvas.

Port of ``tpu_pillars/ops/bev_pallas.py`` (``scatter_to_bev_ring``, same
contract): each valid pillar's C features land at canvas cell ``pid``;
every other cell is zero. Pillar ids are unique per sample (the emit table
holds each pillar once) and ascend (masked pillars last), so the result is
exact with no atomics. On a CUDA tensor :func:`scatter_to_bev` launches
``csrc/bev_scatter.cu``, one block per tile of 64 cells (fixed in the
kernel) that finds its own rows and writes every element of the tile once;
on a CPU tensor it runs :func:`scatter_to_bev_plain`. Its ``out_dtype``
picks one of three instances: f32 rows to an f32 canvas, f32 rows to a
bf16 canvas (each element rounded once, so the canvas equals the f32 one
cast to bf16: bf16 serving) and bf16 rows to a bf16 canvas (bf16
training); other type pairs raise. Training uses
:func:`scatter_to_bev_diff`: the same forward, and the JAX package's
row-gather backward (``bev_pallas.py`` ``_ring_diff_bwd``).
:func:`scatter_to_bev_auto` is the classic front end's entry, with (row,
col) coords.

K9, :func:`scatter_to_bev_emit` (port of ``bev_pallas.py``
``scatter_to_bev_emit``), computes the same canvas under the same
precondition, which both pillarizers guarantee (canonical spec rule 3,
``ops/voxelize.py``). On a CUDA tensor it launches ``csrc/bev_gather.cu``:
a sidecar, :func:`block_row_ranges`, gives each tile of
``GATHER_TILE_CELLS`` cells its first row, as the JAX wrapper's comparison
count does, and one block per (tile, sample) writes every tile once.
Both of K9's kernels take the tile size from here. On a CPU tensor it runs
:func:`scatter_to_bev_emit_plain`.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig

# canvas cells per tile of K9, handed to both of its kernels
GATHER_TILE_CELLS = 64

# K3's instances: (row dtype, canvas dtype) -> its C entry, which is also
# its name in ``_build.LAUNCHES``
SCATTER_INSTANCES = {
    (torch.float32, torch.float32): "bev_scatter",
    (torch.float32, torch.bfloat16): "bev_scatter_f32_bf16",
    (torch.bfloat16, torch.bfloat16): "bev_scatter_bf16",
}
_F32_ONLY = {(torch.float32, torch.float32)}


def _check(feats, pid, mask, out_dtype=torch.float32, pairs=_F32_ONLY):
    if feats.dim() != 3 or pid.shape != feats.shape[:2] \
            or mask.shape != feats.shape[:2]:
        raise ValueError(f"scatter_to_bev wants feats (B, P, C), pid and "
                         f"mask (B, P); got {tuple(feats.shape)}, "
                         f"{tuple(pid.shape)}, {tuple(mask.shape)}")
    if (feats.dtype, out_dtype) not in pairs or pid.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        want = ", ".join(f"{str(a)[6:]} -> {str(b)[6:]}" for a, b in pairs)
        raise TypeError(f"scatter_to_bev wants rows -> canvas in ({want}), "
                        f"int32 ids and a bool mask; got {feats.dtype} -> "
                        f"{out_dtype}, {pid.dtype}, {mask.dtype}")
    if not (feats.device == pid.device == mask.device):
        raise ValueError("scatter_to_bev inputs lie on different devices")


def scatter_to_bev(pillar_features, pid_per, pillar_mask,
                   config: PillarsConfig, out_dtype=torch.float32):
    """(B, P, C) pillar features, (B, P) int32 pillar ids, (B, P) bool
    validity -> (B, H, W, C) canvas of ``out_dtype``. Rows and canvas:
    f32 -> f32, f32 -> bf16 (each element rounded to nearest even once) or
    bf16 -> bf16; any other pair raises (no silent conversion).
    PRECONDITION (the reference's, ``scatter_to_bev_ring``):
    ``where(pillar_mask, pid_per, H*W)`` ascends along P in every sample,
    and the valid ids are unique and lie in [0, H*W) (the emit table's and
    the pillarizers' order); other orders give a wrong canvas on the card.
    Not checked here: that would need a sync with the card. The op
    ``tpu_pillars::scatter_to_bev`` (``_build.kernel_op``):
    :func:`scatter_to_bev_cuda` on a CUDA tensor,
    :func:`scatter_to_bev_plain` on a CPU tensor."""
    _check(pillar_features, pid_per, pillar_mask, out_dtype,
           SCATTER_INSTANCES)
    return _SCATTER_TO_BEV(pillar_features, pid_per, pillar_mask,
                           config.grid_h, config.grid_w, out_dtype)


def scatter_to_bev_cuda(pillar_features: torch.Tensor, pid_per: torch.Tensor,
                        pillar_mask: torch.Tensor, grid_h: int, grid_w: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """K3's launch (the instance of its row and canvas dtypes), the CUDA
    implementation of ``tpu_pillars::scatter_to_bev``."""
    B, P, C = pillar_features.shape
    feats = pillar_features.contiguous()
    pid = pid_per.contiguous()
    mask = pillar_mask.contiguous()
    canvas = torch.empty((B, grid_h, grid_w, C), dtype=out_dtype,
                         device=feats.device)
    symbol = SCATTER_INSTANCES[(feats.dtype, out_dtype)]
    _build.launch("bev_scatter", symbol, "ppppiiii", feats, pid, mask,
                  canvas, B, P, C, grid_h * grid_w, count=symbol)
    return canvas


def _scatter_to_bev_cpu(pillar_features, pid_per, pillar_mask, grid_h,
                        grid_w, out_dtype):
    return scatter_to_bev_plain(pillar_features, pid_per, pillar_mask,
                                SimpleNamespace(grid_h=grid_h, grid_w=grid_w),
                                out_dtype)


def _scatter_to_bev_fake(pillar_features, pid_per, pillar_mask, grid_h,
                         grid_w, out_dtype):
    B, _, C = pillar_features.shape
    return pillar_features.new_empty((B, grid_h, grid_w, C), dtype=out_dtype)


class _ScatterDiff(torch.autograd.Function):
    """K3 forward; the backward is the row gather of the JAX package's
    ``_ring_diff_bwd``: each valid pillar wrote its C features to its own
    cell exactly once, so its cotangent is the canvas cotangent read back
    at that cell (zero where the pillar mask is false; no gradient for the
    ids or the mask)."""

    @staticmethod
    def forward(ctx, pillar_features, pid_per, pillar_mask, config,
                out_dtype):
        ctx.save_for_backward(pid_per, pillar_mask)
        return scatter_to_bev(pillar_features, pid_per, pillar_mask, config,
                              out_dtype)

    @staticmethod
    def backward(ctx, g):
        pid_per, pillar_mask = ctx.saved_tensors
        return (scatter_to_bev_grad(g, pid_per, pillar_mask), None, None,
                None, None)


def scatter_to_bev_grad(g, pid_per, pillar_mask):
    """Cotangent of the pillar features: (B, H, W, C) canvas cotangent ->
    (B, P, C) in the cotangent's dtype, one row gather (the JAX package
    does it in XLA)."""
    B, P = pid_per.shape
    C = g.shape[-1]
    g2 = g.reshape(B, -1, C)
    idx = torch.where(pillar_mask, pid_per, 0).long()
    rows = torch.gather(g2, 1, idx[..., None].expand(B, P, C))
    return rows * pillar_mask[..., None].to(rows.dtype)


def scatter_to_bev_diff(pillar_features, pid_per, pillar_mask,
                        config: PillarsConfig, out_dtype=torch.float32):
    """Differentiable :func:`scatter_to_bev` for training (K3 on the card)
    with the row-gather backward."""
    return _ScatterDiff.apply(pillar_features, pid_per, pillar_mask, config,
                              out_dtype)


def scatter_to_bev_plain(pillar_features, pid_per, pillar_mask,
                         config: PillarsConfig, out_dtype=torch.float32):
    """Plain PyTorch version of :func:`scatter_to_bev`: one masked index
    assignment of the rows, cast to ``out_dtype``, into the flat canvas."""
    _check(pillar_features, pid_per, pillar_mask, out_dtype,
           SCATTER_INSTANCES)
    H, W = config.grid_h, config.grid_w
    B, P, C = pillar_features.shape
    dev = pillar_features.device
    flat = (pid_per.long()
            + torch.arange(B, device=dev)[:, None] * (H * W))
    canvas = torch.zeros((B * H * W, C), dtype=out_dtype, device=dev)
    canvas[flat[pillar_mask]] = pillar_features[pillar_mask].to(out_dtype)
    return canvas.reshape(B, H, W, C)


_SCATTER_TO_BEV = _build.kernel_op(
    "scatter_to_bev", scatter_to_bev_cuda, _scatter_to_bev_cpu,
    _scatter_to_bev_fake)


def scatter_to_bev_auto(pillar_features, coords, pillar_mask,
                        config: PillarsConfig, out_dtype=torch.float32):
    """The classic front end's scatter (``bev_pallas.py``
    ``scatter_to_bev_auto``): (B, P, C) features, (B, P, 2) int32 (row,
    col) coords, (B, P) validity -> (B, H, W, C) canvas through K3, with
    pid = row * W + col, differentiable (:func:`scatter_to_bev_diff`) for
    classic training. The reference's version also picks a backend; this
    one has only K3 and is kept so that the name matches."""
    pid = (coords[..., 0] * config.grid_w + coords[..., 1]).to(torch.int32)
    return scatter_to_bev_diff(pillar_features, pid, pillar_mask, config,
                               out_dtype)


def block_row_ranges(pid_per, pillar_mask, hw: int):
    """K9's sidecar: (B, P) int32 ids, (B, P) bool validity, with
    ``where(pillar_mask, pid_per, hw)`` ascending per sample -> lo (B, T + 1)
    int32, T = ceil(hw / GATHER_TILE_CELLS): ``lo[b, t]`` is the first row
    whose effective id reaches ``t * GATHER_TILE_CELLS`` (the JAX wrapper's
    comparison count ``(pid_eff[:, :, None] < bounds).sum(1)``). Tile t's
    pillars are rows ``lo[b, t]:lo[b, t + 1]``."""
    if pid_per.dtype != torch.int32 or pillar_mask.dtype != torch.bool \
            or pid_per.dim() != 2 or pillar_mask.shape != pid_per.shape:
        raise TypeError(f"block_row_ranges wants (B, P) int32 ids and a "
                        f"(B, P) bool mask, got {pid_per.dtype} "
                        f"{tuple(pid_per.shape)}, {pillar_mask.dtype} "
                        f"{tuple(pillar_mask.shape)}")
    if pid_per.device != pillar_mask.device:
        raise ValueError("block_row_ranges inputs lie on different devices")
    if pid_per.device.type == "cpu":
        return block_row_ranges_plain(pid_per, pillar_mask, hw)
    B, P = pid_per.shape
    tiles = -(-hw // GATHER_TILE_CELLS)
    pid = pid_per.contiguous()
    mask = pillar_mask.contiguous()
    lo = torch.empty((B, tiles + 1), dtype=torch.int32, device=pid.device)
    _build.launch("bev_gather", "bev_row_ranges", "pppiiii", pid, mask, lo, B,
                  P, hw, GATHER_TILE_CELLS, count=False)
    return lo


def block_row_ranges_plain(pid_per, pillar_mask, hw: int):
    """Plain PyTorch version of :func:`block_row_ranges`: one
    ``searchsorted`` of the tile starts in the effective ids."""
    B = pid_per.shape[0]
    tiles = -(-hw // GATHER_TILE_CELLS)
    eff = torch.where(pillar_mask, pid_per, hw).contiguous()
    starts = torch.arange(tiles + 1, dtype=torch.int32,
                          device=eff.device) * GATHER_TILE_CELLS
    return torch.searchsorted(eff, starts.expand(B, -1).contiguous()).to(
        torch.int32)


def scatter_to_bev_emit(pillar_features, pid_per, pillar_mask,
                        config: PillarsConfig):
    """K9: (B, P, C) f32 features, (B, P) int32 ids, (B, P) bool validity
    -> (B, H, W, C) f32 canvas, bit-identical to :func:`scatter_to_bev`.
    PRECONDITION: ``where(pillar_mask, pid_per, H*W)`` ascends along P in
    every sample (the pillarizers' order); other orders give a wrong
    canvas. Not checked here: that would need a sync with the card."""
    _check(pillar_features, pid_per, pillar_mask)
    if pillar_features.device.type == "cpu":
        return scatter_to_bev_emit_plain(pillar_features, pid_per,
                                         pillar_mask, config)
    H, W = config.grid_h, config.grid_w
    B, P, C = pillar_features.shape
    feats = pillar_features.contiguous()
    pid = pid_per.contiguous()
    mask = pillar_mask.contiguous()
    lo = block_row_ranges(pid, mask, H * W)
    canvas = torch.empty((B, H, W, C), dtype=torch.float32,
                         device=feats.device)
    _build.launch("bev_gather", "bev_gather", "pppppiiiii", feats, pid, mask,
                  lo, canvas, B, P, C, H * W, GATHER_TILE_CELLS)
    return canvas


def scatter_to_bev_emit_plain(pillar_features, pid_per, pillar_mask,
                              config: PillarsConfig):
    """Plain PyTorch version of :func:`scatter_to_bev_emit`, the same
    gather: each canvas cell binary-searches the sample's ascending
    effective ids and copies the matching row, or zero."""
    _check(pillar_features, pid_per, pillar_mask)
    H, W = config.grid_h, config.grid_w
    B, P, C = pillar_features.shape
    HW = H * W
    dev = pillar_features.device
    if P == 0:
        return torch.zeros((B, H, W, C), dtype=torch.float32, device=dev)
    eff = torch.where(pillar_mask, pid_per, HW).contiguous()
    cells = torch.arange(HW, dtype=torch.int32, device=dev).expand(B, HW)
    k = torch.searchsorted(eff, cells.contiguous()).clamp(max=P - 1)
    hit = torch.gather(eff, 1, k) == cells
    rows = torch.gather(pillar_features, 1, k[..., None].expand(B, HW, C))
    return torch.where(hit[..., None], rows, 0.0).reshape(B, H, W, C)
