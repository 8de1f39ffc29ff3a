"""Weights drawn from the seed, which a training run hands to the program
and to the reference: every kernel drawn from the seed on the card in one
call, lecun-normal truncated at two standard deviations (flax's default
initializer), BatchNorm scales 1, biases and running means 0, running
variances 1.
"""

from __future__ import annotations

import math

import torch


def _fan_in(name: str, shape) -> int:
    if name == "pfn.kernel" or name.startswith("head."):
        return shape[0]                     # (in, out)
    if ".ups." in name:
        return shape[0] * shape[2] * shape[3]   # (in, out, s, s)
    return shape[1] * shape[2] * shape[3]       # (out, in, 3, 3)


def seeded_state(shapes: dict, seed: int, device) -> dict:
    """{name: shape} in the port's state-dict names -> {name: tensor} on
    ``device``."""
    kernels = [n for n, s in shapes.items()
               if len(s) >= 2 and n != "pfn.bn.weight"]
    total = sum(math.prod(shapes[n]) for n in kernels)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = math.prod(shape)
            std = math.sqrt(1.0 / _fan_in(name, shape)) / 0.87962566103423978
            out[name] = (draw[at:at + n] * std).reshape(shape)
            at += n
        elif name.endswith(("running_var",)) or (
                name.endswith(".weight") and len(shape) == 1):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def state_shapes(cfg) -> dict:
    """The port's state-dict names and shapes, in its order, worked out
    from the configuration (a ``RefConfig``)."""
    shapes = {"pfn.kernel": (cfg.num_decorated_features, cfg.pfn_channels)}

    def bn(prefix, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{s}"] = (c,)

    bn("pfn.bn", cfg.pfn_channels)
    prev = cfg.pfn_channels
    for i, (ch, n) in enumerate(zip(cfg.rpn_channels, cfg.rpn_layers)):
        for j in range(n):
            shapes[f"rpn.blocks.{i}.convs.{j}"] = (ch, prev if j == 0
                                                   else ch, 3, 3)
        for j in range(n):
            bn(f"rpn.blocks.{i}.bns.{j}", ch)
        prev = ch
    for i, ch in enumerate(cfg.rpn_channels):
        s = 2 ** i
        shapes[f"rpn.ups.{i}.weight"] = (ch, cfg.rpn_up_channels, s, s)
        bn(f"rpn.ups.{i}.bn", cfg.rpn_up_channels)
    feat = 3 * cfg.rpn_up_channels
    for name, k in (("cls", cfg.num_classes), ("box", 7), ("dir", 2)):
        shapes[f"head.{name}.weight"] = (feat, cfg.anchors_per_loc * k)
        shapes[f"head.{name}.bias"] = (cfg.anchors_per_loc * k,)
    return shapes
