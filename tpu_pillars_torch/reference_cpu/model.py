"""Torch-CPU PointPillars of the CPU reference — copy of
``tpu_pillars/reference_cpu/model.py``, the reference's model tier, used as
the measured host baseline and as the oracle of the port's model.

Layer for layer the function of the JAX ``models/``: PFN (Linear no-bias +
BN + ReLU + masked max), dense BEV scatter, RPN conv pyramid (3x3 convs,
explicit padding 1), ConvTranspose(k=s) upsample blocks, 1x1 conv SSD head,
in eval mode (running BN statistics). Its state-dict keys are the
reference's layout, which ``convert.torch_to_flax`` reads.
"""

from __future__ import annotations


import torch
import torch.nn as nn

from tpu_pillars_torch.config import PillarsConfig

_BN_EPS = 1e-3


class TorchPFN(nn.Module):
    def __init__(self, in_dim: int, channels: int):
        super().__init__()
        self.linear = nn.Linear(in_dim, channels, bias=False)
        self.bn = nn.BatchNorm1d(channels, eps=_BN_EPS)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # feats (P, N, D), mask (P, N) -> (P, C)
        P, N, _ = feats.shape
        x = self.linear(feats)
        x = self.bn(x.reshape(P * N, -1)).reshape(P, N, -1)
        x = torch.relu(x)
        x = torch.where(mask[..., None], x, torch.full_like(x, -1e9))
        x = x.max(dim=1).values
        return torch.where(mask.any(dim=1, keepdim=True), x, torch.zeros_like(x))


def _conv_bn(in_ch, out_ch, stride):
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False),
        nn.BatchNorm2d(out_ch, eps=_BN_EPS),
        nn.ReLU(),
    )


class TorchRPN(nn.Module):
    def __init__(self, in_ch, channels, layers, up_channels):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.ups = nn.ModuleList()
        prev = in_ch
        for i, (ch, n) in enumerate(zip(channels, layers)):
            mods = [_conv_bn(prev, ch, 2)]
            mods += [_conv_bn(ch, ch, 1) for _ in range(n - 1)]
            self.blocks.append(nn.Sequential(*mods))
            s = 2 ** i
            self.ups.append(
                nn.Sequential(
                    nn.ConvTranspose2d(ch, up_channels, s, stride=s, bias=False),
                    nn.BatchNorm2d(up_channels, eps=_BN_EPS),
                    nn.ReLU(),
                )
            )
            prev = ch

    def forward(self, x):
        ups = []
        for block, up in zip(self.blocks, self.ups):
            x = block(x)
            ups.append(up(x))
        return torch.cat(ups, dim=1)


class TorchPointPillars(nn.Module):
    """Mirror of models.PointPillars; forward(pillars, mask, coords,
    pillar_mask) -> (cls_logits (A, K), box (A, 7), dir (A, 2))."""

    def __init__(self, config: PillarsConfig):
        super().__init__()
        self.config = config
        self.pfn = TorchPFN(config.num_decorated_features, config.pfn_channels)
        self.rpn = TorchRPN(config.pfn_channels, config.rpn_channels,
                            config.rpn_layers, config.rpn_up_channels)
        feat_ch = 3 * config.rpn_up_channels
        A_loc = config.anchors_per_loc
        self.cls = nn.Conv2d(feat_ch, A_loc * config.num_classes, 1)
        self.box = nn.Conv2d(feat_ch, A_loc * 7, 1)
        self.dir = nn.Conv2d(feat_ch, A_loc * 2, 1)

    def scatter(self, pillar_feats, coords, pillar_mask):
        cfg = self.config
        C = pillar_feats.shape[-1]
        canvas = torch.zeros(C, cfg.grid_h * cfg.grid_w,
                             dtype=pillar_feats.dtype)
        flat = (coords[:, 0].long() * cfg.grid_w + coords[:, 1].long())
        live = pillar_mask.bool()
        canvas[:, flat[live]] = pillar_feats[live].t()
        return canvas.reshape(1, C, cfg.grid_h, cfg.grid_w)

    def forward(self, feats, mask, coords, pillar_mask):
        cfg = self.config
        pillar_vec = self.pfn(feats, mask)
        canvas = self.scatter(pillar_vec, coords, pillar_mask)
        fm = self.rpn(canvas)
        A_loc = cfg.anchors_per_loc

        def flat(t, k):
            # (1, A_loc*k, H, W) -> (H, W, A_loc, k) -> (A, k): matches the
            # flax head's NHWC reshape + the anchor layout in ops.anchors
            _, c, H, W = t.shape
            return (
                t[0].reshape(A_loc, k, H, W).permute(2, 3, 0, 1).reshape(-1, k)
            )

        return (
            flat(self.cls(fm), cfg.num_classes),
            flat(self.box(fm), 7),
            flat(self.dir(fm), 2),
        )
