"""The CenterPoint cells' arithmetic: a cloud's counts, the bytes and
operations of the serving kernels at this configuration (K1, K2's
two-layer instance, K3, K4), and the model FLOPs of the serving step. As
in ``kernels.py``, each input byte is counted once when read and each
output byte once when written; a multiply-add counts 2. K4 is counted by
its bytes and the gate test of every pair alone (its bound is low)."""

from __future__ import annotations

import numpy as np

from pillarbench.reference.centerpoint import (
    crop_and_budget, grid, num_input_features,
)
from pillarbench.roofline.kernels import OPS_GATE

# profiler kernel name (a substring of it) -> kernel; the kernel of each
# call counted once (K1 is three launches a call)
KERNEL_NAMES = {"emit_count_kernel": "K1", "emit_runs_kernel": "K1",
                "emit_rows_kernel": "K1", "fpfn2_kernel": "K2b",
                "bev_scatter_kernel": "K3", "nms_overlap_kernel": "K4"}
CALL_NAME = {"K1": "emit_rows_kernel", "K2b": "fpfn2_kernel",
             "K3": "bev_scatter_kernel", "K4": "nms_overlap_kernel"}


def kernel_of(name: str):
    for key, k in KERNEL_NAMES.items():
        if key in name:
            return k
    return None


def cloud_counts(points: np.ndarray, cfg) -> tuple:
    """One cropped cloud (``cfg`` as the reference reads the config) ->
    (valid points, kept pillars, kept points, occupied pillars)."""
    W, H = grid(cfg)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    col = np.floor((x - np.float32(cfg.x_min)) / np.float32(cfg.voxel_x)
                   ).astype(np.int64)
    row = np.floor((y - np.float32(cfg.y_min)) / np.float32(cfg.voxel_y)
                   ).astype(np.int64)
    ok = ((col >= 0) & (col < W) & (row >= 0) & (row < H)
          & (z >= cfg.z_min) & (z <= cfg.z_max))
    _, cnt = np.unique(row[ok] * W + col[ok], return_counts=True)
    kept = cnt[:cfg.max_pillars]
    return (int(ok.sum()), len(kept),
            int(np.minimum(kept, cfg.max_points_per_pillar).sum()), len(cnt))


def mean_counts(clouds, cfg) -> dict:
    """Mean {"valid", "pillars", "kept", "occupied"} over clouds, after the
    host crop and point budget."""
    rows = [cloud_counts(crop_and_budget(c, cfg), cfg) for c in clouds]
    v, p, k, o = (float(np.mean(x)) for x in zip(*rows))
    return {"valid": v, "pillars": p, "kept": k, "occupied": o}


def _dims(cfg: dict):
    f = cfg["num_raw_features"] + (1 if cfg["num_sweeps"] > 1 else 0)
    W = round((cfg["x_max"] - cfg["x_min"]) / cfg["voxel_x"])
    H = round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"])
    c1, c2 = cfg["pfn_channels"][0] // 2, cfg["pfn_channels"][1]
    return f, H, W, cfg["max_pillars"], cfg["max_points_per_pillar"], c1, c2


def k1(cfg: dict, batch: int, valid_points: float):
    """Emit: each valid point's id and row read, the table and its meta
    written. -> (bytes, ops)."""
    f, _, _, p, n, _, _ = _dims(cfg)
    return valid_points * (4 + 4 * f) + batch * p * n * f * 4 \
        + batch * 8 * p * 4, 0.0


def k2_two_layer(cfg: dict, batch: int, kept_points: float):
    """K2's two-layer instance: the kept rows and five meta rows read,
    features, ids and counts written; per kept point layer 1 (F C1
    multiply-adds) and layer 2 on h (C1 C2), per pillar layer 2 on the max
    (C1 C2) and the bias terms."""
    f, _, _, p, _, c1, c2 = _dims(cfg)
    return (kept_points * f * 4 + 5 * batch * p * 4 + batch * p * c2 * 4
            + 2 * batch * p * 4,
            kept_points * 2 * (f * c1 + c1 * c2)
            + batch * p * (2 * c1 * c2 + 14 * c1))


def k3(cfg: dict, batch: int, pillars: float):
    """BEV scatter: the live pillars' rows, ids and mask read, the whole
    canvas written."""
    _, H, W, p, _, _, c2 = _dims(cfg)
    return pillars * c2 * 4 + batch * p * 5 + batch * H * W * c2 * 4, 0.0


def k4(cfg: dict, batch: int):
    """NMS overlap matrix of every (sample, task) row's candidates."""
    k = cfg["nms_pre"]
    rows = batch * len(cfg["tasks"])
    return (rows * k * 7 * 4 + rows * k * k,
            rows * k * (k - 1) / 2 * OPS_GATE)


def kernel_bound(k: str, cfg: dict, batch: int, counts: dict):
    """(bytes, ops) of one call of kernel ``k`` at the pool's mean counts
    (per cloud, times the batch)."""
    if k == "K1":
        return k1(cfg, batch, counts["valid"] * batch)
    if k == "K2b":
        return k2_two_layer(cfg, batch, counts["kept"] * batch)
    if k == "K3":
        return k3(cfg, batch, counts["pillars"] * batch)
    return k4(cfg, batch)


def pfn_flops(cfg: dict, kept_points: float) -> float:
    f, _, _, _, _, c1, c2 = _dims(cfg)
    return 2.0 * kept_points * ((f + 5) * c1 + 2 * c1 * c2)


def rpn_flops(cfg: dict) -> float:
    """3x3 convolutions (the first of each block at stride 2, padding 1)
    and each block's up path to the head's stride (a transposed conv for
    an up-stride of 1 or more, a strided conv below 1)."""
    _, h, w, _, _, _, prev = _dims(cfg)
    up = cfg["rpn_up_channels"]
    total = 0.0
    for ch, n, s in zip(cfg["rpn_channels"], cfg["rpn_layers"],
                        cfg["rpn_up_strides"]):
        h, w = (h + 1) // 2, (w + 1) // 2
        total += 2.0 * prev * ch * 9 * h * w
        total += (n - 1) * 2.0 * ch * ch * 9 * h * w
        if s >= 1:       # each input pixel to an s x s patch
            total += 2.0 * ch * up * s * s * h * w
        else:            # each output pixel from a k x k patch
            k = round(1 / s)
            total += 2.0 * ch * up * k * k * (h // k) * (w // k)
        prev = ch
    return total


def head_flops(cfg: dict) -> float:
    """The centre head at the head's stride: the shared 3x3 conv, each
    task's 3x3 convs head_conv -> head_conv, and its output convs."""
    _, H, W, _, _, _, _ = _dims(cfg)
    hw = (H // cfg["out_stride"]) * (W // cfg["out_stride"])
    c, cin = cfg["head_conv"], len(cfg["rpn_channels"]) * cfg[
        "rpn_up_channels"]
    reg = sum(n for _, n in cfg["common_heads"])
    total = 2.0 * cin * c * 9 * hw
    for t in cfg["tasks"]:
        branches = len(cfg["common_heads"]) + 1
        total += branches * 2.0 * c * c * 9 * hw
        total += 2.0 * c * (reg + len(t["classes"])) * 9 * hw
    return total


def serving_flops(cfg: dict, kept_points: float) -> float:
    """One cloud's forward as served."""
    return pfn_flops(cfg, kept_points) + rpn_flops(cfg) + head_flops(cfg)
