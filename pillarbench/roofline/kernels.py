"""Bytes and operations of the port's hand-written kernels per call, as
functions of the call's shapes and of counts taken from its inputs, and
the names by which the profiler shows them.

Each input byte is counted once when read and each output byte once when
written (the port's smoke test's arithmetic). K4 and K5 are counted by
their bytes and the gate test of every pair alone: their exact work turns
on which pairs pass the gate, which the harness does not see, so their
bounds, and the shares built on them, are low."""

from __future__ import annotations

# profiler kernel name (a substring of it) -> kernel
KERNEL_NAMES = {
    "emit_count_kernel": "K1", "emit_runs_kernel": "K1",
    "emit_rows_kernel": "K1", "fpfn_kernel": "K2",
    "bev_scatter_kernel": "K3", "nms_overlap_kernel": "K4",
    "assign_kernel": "K5",
}
# the kernel of each call counted once: K1 is three launches a call
CALL_NAME = {"K1": "emit_rows_kernel", "K2": "fpfn_kernel",
             "K3": "bev_scatter_kernel", "K4": "nms_overlap_kernel",
             "K5": "assign_kernel"}
OPS_GATE = 8         # a pair's circumcircle test, as the smoke test counts


def kernel_of(name: str):
    for key, k in KERNEL_NAMES.items():
        if key in name:
            return k
    return None


def _dims(cfg: dict):
    f = cfg["num_raw_features"] + (1 if cfg["num_sweeps"] > 1 else 0)
    hw = (round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"])
          * round((cfg["x_max"] - cfg["x_min"]) / cfg["voxel_x"]))
    return f, hw, cfg["max_pillars"], cfg["max_points_per_pillar"], \
        cfg["pfn_channels"]


def k1(cfg: dict, batch: int, valid_points: float):
    """Emit: each valid point's id and row read, the table and its meta
    written. -> (bytes, ops)."""
    f, _, p, n, _ = _dims(cfg)
    return valid_points * (4 + 4 * f) + batch * p * n * f * 4 \
        + batch * 8 * p * 4, 0.0


def k2(cfg: dict, batch: int, kept_points: float):
    """Fused PFN: the kept rows and five meta rows read, features, ids and
    counts written; a multiply-add per kept point, feature and channel, and
    the per-pillar epilogue."""
    f, _, p, _, c = _dims(cfg)
    return (kept_points * f * 4 + 5 * batch * p * 4 + batch * p * c * 4
            + 2 * batch * p * 4,
            kept_points * c * 2 * f + batch * p * c * 14)


def k3(cfg: dict, batch: int, pillars: float, out_bytes: int = 4):
    """BEV scatter: the live pillars' rows, ids and mask read, the whole
    canvas written."""
    _, hw, p, _, c = _dims(cfg)
    return pillars * c * 4 + batch * p * 5 + batch * hw * c * out_bytes, 0.0


def k4(cfg: dict, batch: int):
    """NMS overlap matrix of the top-k boxes: the boxes read, one byte a
    pair written; the gate of every upper-triangle pair."""
    k = cfg["pre_nms_top_k"]
    return (batch * k * 7 * 4 + batch * k * k,
            batch * k * (k - 1) / 2 * OPS_GATE)


def k5(cfg: dict, batch: int, gt_per_class: int):
    """Windowed best IoU: GT and anchor planes read, best IoU and index per
    anchor and per GT written."""
    c = len(cfg["classes"])
    a = (round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"])
         // cfg["head_stride"]) * (round((cfg["x_max"] - cfg["x_min"])
                                         / cfg["voxel_x"])
                                   // cfg["head_stride"])
    ac = a * len(cfg["anchor_yaws"])
    return (batch * c * gt_per_class * (7 * 4 + 1) + c * 12 * ac * 4
            + batch * c * ac * 12 + batch * c * gt_per_class * 12, 0.0)
