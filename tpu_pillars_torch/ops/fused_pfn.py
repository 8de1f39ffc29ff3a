"""Decoration-free fused PFN: pillar features straight from the emit table.

Port of ``tpu_pillars/ops/fused_pfn.py``. The PFN's linear layer is linear in
the decorated features, and the decoration is affine in the raw point given
the pillar's mean and cell centre. Working in CELL-CENTERED locals
x' = x - cx, y' = y - cy:

    W^T d_j + b = W_eff^T r'_j + t,   r'_j = [x', y', z, i(, dt)]
        W_eff[x] = W[x] + W[xc] + W[xp]   (similarly y; z gets W[zc])
        t        = b + cx W[x] + cy W[y] - mx' W[xc] - my' W[yc] - mz W[zc]

and ReLU is monotone, so max_j relu(W^T d_j + b) = relu(max_j W_eff^T r'_j
+ t): the decorated (P, N, D) tensor never exists. ``pfn_from_table``
(K2) runs that on the emit table; on a CPU tensor it runs
:func:`pfn_from_table_plain`, on a CUDA tensor it makes one launch of
``csrc/fused_pfn.cu`` into ``torch.empty`` (features, int32 ids and f32
counts, all three written by the kernel) and runs no other torch op.

What bounds the kernel is bytes, four fifths of them the feature store.
The first port gave each thread one (pillar, channel), so a pillar's count,
rows, meta and weights were loaded 64 times and waited on one after
another. Now a block of four warps takes 128 pillars: their meta in five
coalesced loads, a block scan that numbers their kept rows, the pillars
split between the warps by work (rows and pillars), one row a lane staged
in shared memory and read back as broadcasts (slots past the count never
read), and each lane's channels and weights in registers; the design
notes are in the ``.cu`` header.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch

from tpu_pillars_torch import _build
from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.emit import META_ROWS, emit_table
from tpu_pillars_torch.ops.voxelize import sort_points_by_pillar


def fold_bn(weight, scale, bias, mean, var, eps: float = 1e-3):
    """Fold inference BatchNorm into the PFN linear. weight (D, C)."""
    inv = scale * torch.rsqrt(var + eps)
    return weight * inv[None, :], bias - mean * inv


def fold_decoration(w, b, config: PillarsConfig):
    """Folded decorated-space PFN weights (D, C), (C,) -> (w_eff (F, C),
    w_dec (8, C)) with w_dec rows [w_xc, w_yc, w_zc, -w_x, -w_y, b, 0, 0]
    (the sign flip keeps one t-formula that subtracts rows 3/4 times the
    cell centre). Decorated layout: raw F cols, (xc, yc, zc), (xp, yp)."""
    F = config.num_input_features
    C = w.shape[1]
    if w.shape[0] != F + 5:
        raise ValueError(f"PFN weight has {w.shape[0]} rows; the config "
                         f"decorates to {F + 5}")
    w_eff = torch.cat([
        (w[0] + w[F + 0] + w[F + 3])[None],      # x
        (w[1] + w[F + 1] + w[F + 4])[None],      # y
        (w[2] + w[F + 2])[None],                 # z
        w[3:F],                                  # intensity (, dt)
    ], dim=0)
    w_dec = torch.cat([w[F:F + 3], -w[0][None], -w[1][None], b[None],
                       torch.zeros((2, C), dtype=w.dtype, device=w.device)],
                      dim=0)
    return w_eff, w_dec


def _split_meta(meta, p_rows):
    B = meta.shape[0] // META_ROWS
    m = meta.reshape(B, META_ROWS, p_rows)
    return B, m[:, 0], m[:, 1].to(torch.int32)


def pfn_from_table(table, meta, w_eff, w_dec, config: PillarsConfig):
    """K2. table (B*P, N*F), meta (B*8, P) (``ops.emit.emit_table``),
    w_eff (F, C), w_dec (8, C) (:func:`fold_decoration`) ->
    (feats (B, P, C) f32, pid_per (B, P) int32, cnt (B, P) f32). The op
    ``tpu_pillars::pfn_from_table`` (``_build.kernel_op``) on the config's
    :func:`geometry`: :func:`pfn_from_table_cuda` on a CUDA tensor,
    :func:`pfn_from_table_plain` on a CPU tensor."""
    return _PFN_FROM_TABLE(table, meta, w_eff, w_dec, *geometry(config))


def geometry(config: PillarsConfig) -> tuple:
    """The config's fields that K2 reads, in its op's argument order: N,
    the grid width and the grid's origin and pitch."""
    return (config.max_points_per_pillar, config.grid_w, config.x_min,
            config.y_min, config.voxel_x, config.voxel_y)


def pfn_from_table_cuda(table: torch.Tensor, meta: torch.Tensor,
                        w_eff: torch.Tensor, w_dec: torch.Tensor, n_pts: int,
                        grid_w: int, x_min: float, y_min: float,
                        voxel_x: float, voxel_y: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's launch, the CUDA implementation of
    ``tpu_pillars::pfn_from_table``."""
    dev = table.device
    for name, t in (("table", table), ("meta", meta), ("w_eff", w_eff),
                    ("w_dec", w_dec)):
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"pfn_from_table: {name} must be float32 on "
                            f"{dev}, got {t.dtype} on {t.device}")
    N = n_pts
    F, C = w_eff.shape
    p_rows = meta.shape[1]
    B = meta.shape[0] // META_ROWS
    rows = B * p_rows
    if meta.shape[0] != B * META_ROWS or table.shape != (rows, N * F) \
            or w_dec.shape != (META_ROWS, C):
        raise ValueError(f"pfn_from_table: table {tuple(table.shape)} / "
                         f"w_dec {tuple(w_dec.shape)} do not fit meta "
                         f"{tuple(meta.shape)}, N={N}, F={F}, C={C}")
    table, meta = table.contiguous(), meta.contiguous()
    w_eff, w_dec = w_eff.contiguous(), w_dec.contiguous()
    out = torch.empty((B, p_rows, C), dtype=torch.float32, device=dev)
    pid = torch.empty((B, p_rows), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, p_rows), dtype=torch.float32, device=dev)
    _build.launch("fused_pfn", "fused_pfn", "pppppppiiiiiiffff", table, meta,
                  w_eff, w_dec, out, pid, cnt, rows, p_rows, N, F, C,
                  grid_w, x_min, y_min, voxel_x, voxel_y)
    return out, pid, cnt


def _pfn_from_table_cpu(table, meta, w_eff, w_dec, n_pts, grid_w, x_min,
                        y_min, voxel_x, voxel_y):
    return pfn_from_table_plain(table, meta, w_eff, w_dec, SimpleNamespace(
        max_points_per_pillar=n_pts, grid_w=grid_w, x_min=x_min, y_min=y_min,
        voxel_x=voxel_x, voxel_y=voxel_y))


def _pfn_from_table_fake(table, meta, w_eff, *_):
    B, P = meta.shape[0] // META_ROWS, meta.shape[1]
    C = w_eff.shape[1]
    return (table.new_empty((B, P, C)),
            table.new_empty((B, P), dtype=torch.int32),
            table.new_empty((B, P)))


def pfn_from_table_plain(table, meta, w_eff, w_dec, config: PillarsConfig):
    """Plain PyTorch version of :func:`pfn_from_table` — the JAX package's
    ``pfn_from_table_xla`` (same -1e9 mask and t-bias), with the F-term
    product summed in the kernel's order so the two agree bit for bit."""
    N = config.max_points_per_pillar
    F, C = w_eff.shape
    p_rows = meta.shape[1]
    B, cnt_b, pid_b = _split_meta(meta, p_rows)
    rows = B * p_rows
    m = meta.reshape(B, META_ROWS, p_rows)
    cnt = cnt_b.reshape(rows, 1)
    pid = pid_b.reshape(rows)

    X = table[:, :N * F].reshape(rows, N, 1, F)
    u = X[..., 0] * w_eff[0]
    for f in range(1, F):
        u = u + X[..., f] * w_eff[f]                             # (rows, N, C)
    seg = torch.arange(N, dtype=torch.float32, device=table.device)
    u = torch.where((seg[None, :] < cnt)[..., None], u, -1e9)
    smax = u.amax(dim=1)                                         # (rows, C)

    col = (pid % config.grid_w).to(torch.float32)[:, None]
    row = (pid // config.grid_w).to(torch.float32)[:, None]
    cx = config.x_min + (col + 0.5) * config.voxel_x
    cy = config.y_min + (row + 0.5) * config.voxel_y
    inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
    mx = m[:, 2].reshape(rows, 1) * inv_cnt
    my = m[:, 3].reshape(rows, 1) * inv_cnt
    mz = m[:, 4].reshape(rows, 1) * inv_cnt
    t = (w_dec[5] - mx * w_dec[0] - my * w_dec[1] - mz * w_dec[2]
         - cx * w_dec[3] - cy * w_dec[4])
    out = torch.where(cnt > 0.0, torch.clamp(smax + t, min=0.0), 0.0)
    return out.reshape(B, p_rows, C), pid_b, cnt_b


_PFN_FROM_TABLE = _build.kernel_op(
    "pfn_from_table", pfn_from_table_cuda, _pfn_from_table_cpu,
    _pfn_from_table_fake)


def _cell_centres(pid, config: PillarsConfig):
    col = (pid % config.grid_w).to(torch.float32)[:, None]
    row = (pid // config.grid_w).to(torch.float32)[:, None]
    return (config.x_min + (col + 0.5) * config.voxel_x,
            config.y_min + (row + 0.5) * config.voxel_y)


def pfn_from_table_diff(table, meta, w_eff, w_dec, config: PillarsConfig):
    """Differentiable twin of :func:`pfn_from_table` for training — the JAX
    package's ``pfn_from_table_xla``: one (rows*N, F) @ w_eff matmul, the
    -1e9 mask, a masked max (``amax``, whose gradient splits evenly among
    ties as JAX's max does) and the t-bias, in stock torch ops (the JAX
    package runs this pass in XLA, outside any kernel). Same outputs as
    :func:`pfn_from_table`."""
    N = config.max_points_per_pillar
    F, C = w_eff.shape
    p_rows = meta.shape[1]
    B, cnt_b, pid_b = _split_meta(meta, p_rows)
    rows = B * p_rows
    m = meta.reshape(B, META_ROWS, p_rows)
    cnt = cnt_b.reshape(rows)
    pid = pid_b.reshape(rows)

    X = table[:, :N * F].reshape(rows * N, F)
    seg = torch.arange(N, dtype=torch.float32, device=table.device)
    mask = seg[None, :] < cnt[:, None]                         # (rows, N)
    u = (X @ w_eff).reshape(rows, N, C)
    u = torch.where(mask[..., None], u, -1e9)
    smax = u.amax(dim=1)                                       # (rows, C)

    cx, cy = _cell_centres(pid, config)
    inv_cnt = (1.0 / torch.clamp(cnt, min=1.0))[:, None]
    mx = m[:, 2].reshape(rows)[:, None] * inv_cnt
    my = m[:, 3].reshape(rows)[:, None] * inv_cnt
    mz = m[:, 4].reshape(rows)[:, None] * inv_cnt
    t = (w_dec[5][None] - mx * w_dec[0][None] - my * w_dec[1][None]
         - mz * w_dec[2][None] - cx * w_dec[3][None] - cy * w_dec[4][None])
    out = torch.where((cnt > 0.0)[:, None],
                      torch.clamp(smax + t, min=0.0), 0.0)
    return out.reshape(B, p_rows, C), pid_b, cnt_b


def pfn_train_from_table(table, meta, w, bn_scale, bn_bias,
                         config: PillarsConfig, eps: float = 1e-3,
                         mesh=None):
    """Train-mode fused PFN: decorated-space linear + masked BatchNorm on
    the batch statistics + ReLU + masked max, without the decorated
    (B, P, N, D) or post-linear tensors for the statistics. Port of the JAX
    package's ``pfn_train_from_table``.

    With y_j = W_eff^T r'_j + t_p(j) (module docstring), the masked moments
    per channel come from sufficient statistics of the table:

        E[y]  = (W_eff^T sum r' + sum_p cnt_p t_p) / n
        E[y^2] = (diag(W_eff^T S W_eff) + 2 sum_p t_p (s_p W_eff)
                  + sum_p cnt_p t_p^2) / n,        S = sum r' r'^T (F x F)

    var = max(E[y^2] - E[y]^2, 0) (biased, count clamped to >= 1). The
    batch affine then folds into the weights (:func:`fold_bn`) and one
    :func:`pfn_from_table_diff` pass gives the features. Differentiable in
    w, bn_scale and bn_bias. With a ``mesh`` (``parallel.Mesh``) n, sum
    r', S and the three t sums are summed over its ranks first (sync-BN
    over the global batch: one all-reduce of F^2 + F + 3C + 1 floats).

    w (D, C) decorated-space kernel; bn_scale, bn_bias (C,) ->
    (feats (B, P, C), pid (B, P) int32, cnt (B, P), batch_mean (C,),
    batch_var (C,)); the caller owns the running-average update."""
    N = config.max_points_per_pillar
    F = config.num_input_features
    C = w.shape[1]
    if w.shape[0] != F + 5:
        raise ValueError(f"PFN weight has {w.shape[0]} rows; the config "
                         f"decorates to {F + 5}")
    p_rows = meta.shape[1]
    B, cnt_b, pid_b = _split_meta(meta, p_rows)
    rows = B * p_rows
    cnt = cnt_b.reshape(rows)
    pid = pid_b.reshape(rows)

    X = table[:, :N * F].reshape(rows, N, F)
    seg = torch.arange(N, dtype=torch.float32, device=table.device)
    Xm = X * (seg[None, :] < cnt[:, None]).to(torch.float32)[..., None]

    s_p = Xm.sum(dim=1)                                        # (rows, F)
    sbar = s_p.sum(dim=0)                                      # (F,)
    flat = Xm.reshape(rows * N, F)
    S = flat.t() @ flat                                        # (F, F)

    w_eff, _ = fold_decoration(w, torch.zeros_like(w[0]), config)
    # per-pillar decoration bias t (the linear has no bias): t = cx w_x +
    # cy w_y - mx' w_xc - my' w_yc - mz w_zc (locals x' = x - cell centre)
    cx, cy = _cell_centres(pid, config)
    inv_cnt = (1.0 / torch.clamp(cnt, min=1.0))[:, None]
    mean_xyz = s_p[:, :3] * inv_cnt
    t = (cx * w[0][None] + cy * w[1][None]
         - mean_xyz[:, 0:1] * w[F + 0][None]
         - mean_xyz[:, 1:2] * w[F + 1][None]
         - mean_xyz[:, 2:3] * w[F + 2][None])                  # (rows, C)
    t = torch.where((cnt > 0.0)[:, None], t, 0.0)

    m_p = s_p @ w_eff                                          # (rows, C)
    n_sum = cnt.sum()
    t_cnt = (cnt[:, None] * t).sum(dim=0)
    t_mp = (t * m_p).sum(dim=0)
    t_sq = (cnt[:, None] * t * t).sum(dim=0)
    if mesh is not None:
        # sync-BN: the sufficient statistics summed over the ranks, one
        # flat buffer (differentiable: t depends on w)
        flat = mesh.psum(torch.cat([n_sum[None], sbar, S.reshape(-1), t_cnt,
                                    t_mp, t_sq]))
        n_sum, sbar = flat[0], flat[1:1 + F]
        S = flat[1 + F:1 + F + F * F].reshape(F, F)
        t_cnt, t_mp, t_sq = flat[1 + F + F * F:].chunk(3)
    n = torch.clamp(n_sum, min=1.0)
    mean = (sbar @ w_eff + t_cnt) / n
    e_u2 = ((S @ w_eff) * w_eff).sum(dim=0) / n
    var = torch.clamp(e_u2 + 2.0 * (t_mp / n) + t_sq / n - mean * mean,
                      min=0.0)

    a = bn_scale * torch.rsqrt(var + eps)
    w_eff2, w_dec2 = fold_decoration(w * a[None, :], bn_bias - mean * a,
                                     config)
    feats, pid_out, cnt_out = pfn_from_table_diff(table, meta, w_eff2,
                                                  w_dec2, config)
    return feats, pid_out, cnt_out, mean, var


def center_points(gid_sorted, pts_sorted, config: PillarsConfig):
    """Cell-centre the sorted payload: x' = x - cx, y' = y - cy with (cx,
    cy) each point's own cell centre (exact f32 subtracts). Invalid rows
    (gid == H*W) get a harmless out-of-grid centre; they are never kept."""
    col = (gid_sorted % config.grid_w).to(torch.float32)
    row = (gid_sorted // config.grid_w).to(torch.float32)
    cx = config.x_min + (col + 0.5) * config.voxel_x
    cy = config.y_min + (row + 0.5) * config.voxel_y
    return torch.cat([(pts_sorted[..., 0] - cx)[..., None],
                      (pts_sorted[..., 1] - cy)[..., None],
                      pts_sorted[..., 2:]], dim=-1)


def emit_centered_table(points, num_points, config: PillarsConfig):
    """Sort by pillar id, cell-centre the payload, run the emit kernel (K1).
    Returns (table (B*P, N*F), meta (B*8, P)) — the inputs of
    :func:`pfn_from_table`. Meta sums are sums of the locals, which is what
    :func:`fold_decoration`'s t expects."""
    F = points.shape[-1]
    if F != config.num_input_features:
        raise ValueError(
            f"points have {F} features; config expects "
            f"{config.num_input_features} (num_raw_features="
            f"{config.num_raw_features}, num_sweeps={config.num_sweeps})")
    gid_s, pts_s = sort_points_by_pillar(points, num_points, config)
    pts_s = center_points(gid_s, pts_s, config)
    return emit_table(gid_s, pts_s, config.max_points_per_pillar,
                      config.max_pillars, config.grid_h * config.grid_w)


def pillarize_pfn_fused(points, num_points, w, b, config: PillarsConfig):
    """The fused serving front end: (B, M, F) points + folded decorated-
    space PFN weights (:func:`fold_bn` output) ->
    (pillar_feats (B, P, C) f32, pid_per (B, P) int32, pillar_mask (B, P)
    bool), ready for the BEV scatter."""
    table, meta = emit_centered_table(points, num_points, config)
    w_eff, w_dec = fold_decoration(w, b, config)
    feats, pid_per, cnt = pfn_from_table(table, meta, w_eff, w_dec, config)
    return feats, pid_per, cnt > 0.0
