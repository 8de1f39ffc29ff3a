"""CenterPoint-PP weights drawn from the seed, which the ``offline_center``
loop hands to the program and to the reference alike. Every kernel is
drawn on the card in one call, lecun-normal truncated at two standard
deviations (the regression heads' output kernels at a fifth of that);
the BatchNorm scales U(0.8, 1.2) and biases N(0, 0.1^2); the conv biases
0 but the heatmaps', -2.19 as published, the dims' (the log of the task's
first class's mean size), the heights' (-1 m) and the rots' ((sin, cos)
= (0, 1)); then each BatchNorm's running statistics are the moments of
its input over calibration clouds of the pool, moved by a draw
(``reference.centerpoint.calibrate``), so that no BatchNorm is the
identity and every layer keeps a trained network's scale.

The names and shapes are worked out from the configuration file's
``config`` alone, in the port's state-dict names
(``tpu_pillars_torch.models.centerpoint.CenterPoint``).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

HEATMAP_BIAS = -2.19
# the regression heads' output kernels at a fifth of lecun's scale, the
# dim bias the log of the task's first class's mean size, the height bias
# a box centre's height and the rot bias (sin, cos) = (0, 1): boxes of an
# object's size about where objects stand, with (sin, cos) near the unit
# circle, as a trained head gives them. At lecun's scale exp(dim) reaches
# hundreds of metres and (sin, cos) comes near (0, 0), where atan2
# magnifies rounding a thousandfold: the boxes, not the program, would set
# the gaps the comparison sees.
REGRESSION_SCALE = 0.2
HEIGHT_BIAS = -1.0
ROT_BIAS = (0.0, 1.0)


def ref_config(fields: dict) -> SimpleNamespace:
    """The config file's ``config`` as the reference reads it (tasks with
    ``classes``)."""
    cfg = SimpleNamespace(**{k: v for k, v in fields.items()
                             if k != "tasks"})
    cfg.tasks = [SimpleNamespace(**t) for t in fields["tasks"]]
    return cfg


def branches(fields: dict, task: int):
    return [tuple(h) for h in fields["common_heads"]] + [
        ("hm", len(fields["tasks"][task]["classes"]))]


def state_shapes(fields: dict) -> dict:
    """{name: shape} of every weight and statistic, in the port's order."""
    shapes = {}

    def bn(prefix, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{s}"] = (c,)

    d = fields["num_raw_features"] + (1 if fields["num_sweeps"] > 1 else 0) \
        + 5
    c1, c2 = fields["pfn_channels"][0] // 2, fields["pfn_channels"][1]
    shapes["pfn.w1"] = (d, c1)
    bn("pfn.bn1", c1)
    shapes["pfn.w2"] = (2 * c1, c2)
    bn("pfn.bn2", c2)
    prev = c2
    up = fields["rpn_up_channels"]
    for i, (ch, n) in enumerate(zip(fields["rpn_channels"],
                                    fields["rpn_layers"])):
        for j in range(n):
            shapes[f"rpn.blocks.{i}.convs.{j}"] = (ch, prev if j == 0
                                                   else ch, 3, 3)
        for j in range(n):
            bn(f"rpn.blocks.{i}.bns.{j}", ch)
        s = fields["rpn_up_strides"][i]
        k = int(round(s if s >= 1 else 1 / s))
        shapes[f"rpn.ups.{i}.weight"] = ((ch, up, k, k) if s >= 1
                                         else (up, ch, k, k))
        bn(f"rpn.ups.{i}.bn", up)
        prev = ch
    hc = fields["head_conv"]
    shapes["head.shared_w"] = (hc, len(fields["rpn_channels"]) * up, 3, 3)
    shapes["head.shared_b"] = (hc,)
    bn("head.shared_bn", hc)
    for t in range(len(fields["tasks"])):
        for name, n in branches(fields, t):
            p = f"head.tasks.{t}.{name}"
            shapes[p + ".w1"] = (hc, hc, 3, 3)
            shapes[p + ".b1"] = (hc,)
            bn(p + ".bn", hc)
            shapes[p + ".w2"] = (n, hc, 3, 3)
            shapes[p + ".b2"] = (n,)
    return shapes


def _fan_in(name: str, shape, fields: dict) -> int:
    if name.startswith("pfn."):
        return shape[0]                      # (in, out)
    if name.startswith("rpn.ups."):
        s = fields["rpn_up_strides"][int(name.split(".")[2])]
        if s >= 1:                           # transposed: (in, out, k, k),
            return shape[0]                  # k = s: one tap an output
    return math.prod(shape[1:])              # (out, in, k, k)


def drawn_state(fields: dict, seed: int, device) -> dict:
    """The weights before calibration, on ``device``."""
    shapes = state_shapes(fields)
    kernels = [n for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(shapes[n]) for n in kernels)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = math.prod(shape)
            std = math.sqrt(1.0 / _fan_in(name, shape, fields)) \
                / 0.87962566103423978
            out[name] = (draw[at:at + n] * std).reshape(shape)
            at += n
        elif name.endswith(".weight"):          # BatchNorm scales
            out[name] = 0.8 + 0.4 * torch.rand(shape, generator=gen,
                                               device=device)
        elif name.endswith(".bias"):            # BatchNorm biases
            out[name] = 0.1 * torch.randn(shape, generator=gen,
                                          device=device)
        elif name.endswith("running_var"):
            out[name] = torch.ones(shape, device=device)
        else:                                   # conv biases, means
            out[name] = torch.zeros(shape, device=device)
    for t, task in enumerate(fields["tasks"]):
        p = f"head.tasks.{t}."
        out[p + "hm.b2"].fill_(HEATMAP_BIAS)
        for name, _ in fields["common_heads"]:
            out[p + name + ".w2"] *= REGRESSION_SCALE
        out[p + "rot.b2"].copy_(torch.tensor(ROT_BIAS, device=device))
        out[p + "dim.b2"].copy_(torch.log(torch.tensor(
            task["sizes"][0], device=device)))
        out[p + "height.b2"].fill_(HEIGHT_BIAS)
    return out


def seeded_state(fields: dict, seed: int, clouds, device) -> dict:
    """Drawn weights, their BatchNorms calibrated on ``clouds``."""
    from pillarbench.reference.centerpoint import calibrate

    w = drawn_state(fields, seed, device)
    gen = torch.Generator(device=device).manual_seed((seed + 1) % (2 ** 63))
    return calibrate(w, ref_config(fields), clouds, gen)
