"""Model FLOPs of the detector per sweep (a multiply-add counts 2): the
PFN's linear layer on the kept points, the RPN's 3x3 convolutions and
transposed convolutions, and the head's 1x1 convolutions. BatchNorm,
ReLU, max and the scatter are left out (they are bytes, not FLOPs)."""

from __future__ import annotations


def pfn_flops(cfg: dict, kept_points: float) -> float:
    d = cfg["num_raw_features"] + (1 if cfg["num_sweeps"] > 1 else 0) + 5
    return 2.0 * kept_points * d * cfg["pfn_channels"]


def rpn_flops(cfg: dict) -> float:
    """3x3 convolutions (the first of each block at stride 2, padding 1)
    and each block's transposed convolution back to the head's stride."""
    h = round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"])
    w = round((cfg["x_max"] - cfg["x_min"]) / cfg["voxel_x"])
    prev = cfg["pfn_channels"]
    total = 0.0
    for i, (ch, n) in enumerate(zip(cfg["rpn_channels"], cfg["rpn_layers"])):
        h, w = (h + 1) // 2, (w + 1) // 2
        total += 2.0 * prev * ch * 9 * h * w
        total += (n - 1) * 2.0 * ch * ch * 9 * h * w
        s = 2 ** i
        total += 2.0 * ch * cfg["rpn_up_channels"] * s * s * h * w
        prev = ch
    return total


def head_flops(cfg: dict, own_class_only: bool) -> float:
    """The head's 1x1 convolutions at the head's stride: serving computes
    each anchor's own-class logit, training every class's."""
    hf = round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"]) \
        // cfg["head_stride"]
    wf = round((cfg["x_max"] - cfg["x_min"]) / cfg["voxel_x"]) \
        // cfg["head_stride"]
    a_loc = len(cfg["classes"]) * len(cfg["anchor_yaws"])
    k = 1 if own_class_only else len(cfg["classes"])
    cols = a_loc * (k + 7 + 2)
    return 2.0 * 3 * cfg["rpn_up_channels"] * cols * hf * wf


def serving_flops(cfg: dict, kept_points: float) -> float:
    """One sweep's forward as served (own-class head)."""
    return (pfn_flops(cfg, kept_points) + rpn_flops(cfg)
            + head_flops(cfg, own_class_only=True))


def training_flops(cfg: dict, kept_points: float) -> float:
    """One sample's training step, taken as 3x its forward (recomputation
    not counted)."""
    return 3.0 * (pfn_flops(cfg, kept_points) + rpn_flops(cfg)
                  + head_flops(cfg, own_class_only=False))
