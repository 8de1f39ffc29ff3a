"""RPN backbone: top-down 2-D conv pyramid + upsample-and-concat, eval mode.

Port of ``tpu_pillars/models/backbone.py``. Three down blocks (stride 2
each), each deconvolved back to the head stride and concatenated. The convs
stay ``torch.nn.functional`` calls (the JAX package left them to XLA);
BatchNorm uses its running statistics (eps 1e-3). Tensors run NCHW in
``channels_last`` memory, so a (B, H, W, C) canvas enters as a permuted
view with no copy.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with running statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


class ConvBlock(nn.Module):
    """`layers` x [3x3 conv (padding 1, no bias) + BN + ReLU]; the first
    conv has `stride`."""

    def __init__(self, in_ch: int, channels: int, layers: int,
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.convs = nn.ParameterList(
            [nn.Parameter(torch.zeros(channels, in_ch if i == 0 else channels,
                                      3, 3), requires_grad=False)
             for i in range(layers)])
        self.bns = nn.ModuleList(FrozenBatchNorm(channels)
                                 for _ in range(layers))

    def forward(self, x):
        for i, (w, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.conv2d(x, w, stride=self.stride if i == 0 else 1,
                         padding=1)
            x = torch.relu(bn(x))
        return x


class UpBlock(nn.Module):
    """ConvTranspose(k=stride, s=stride, no padding) + BN + ReLU."""

    def __init__(self, in_ch: int, channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(in_ch, channels, stride,
                                               stride), requires_grad=False)
        self.bn = FrozenBatchNorm(channels)

    def forward(self, x):
        return torch.relu(self.bn(F.conv_transpose2d(x, self.weight,
                                                     stride=self.stride)))


class RPNBackbone(nn.Module):
    """(B, C_in, H, W) -> (B, 3 * up_channels, H/2, W/2)."""

    def __init__(self, in_ch: int, channels: Sequence[int] = (64, 128, 256),
                 layers: Sequence[int] = (4, 6, 6), up_channels: int = 128):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.ups = nn.ModuleList()
        prev = in_ch
        for i, (ch, n) in enumerate(zip(channels, layers)):
            self.blocks.append(ConvBlock(prev, ch, n, stride=2))
            # block i sits at stride 2^(i+1); the head lives at stride 2
            self.ups.append(UpBlock(ch, up_channels, 2 ** i))
            prev = ch

    def forward(self, x):
        ups = []
        for block, up in zip(self.blocks, self.ups):
            x = block(x)
            ups.append(up(x))
        return torch.cat(ups, dim=1)
