"""RPN backbone: top-down 2-D conv pyramid + upsample-and-concat.

Port of ``tpu_pillars/models/backbone.py``. Three down blocks (stride 2
each), each deconvolved back to the head stride and concatenated. The convs
stay ``torch.nn.functional`` calls (the JAX package left them to XLA).
Tensors run NCHW in ``channels_last`` memory, so a (B, H, W, C) canvas
enters as a permuted view with no copy.

BatchNorm (eps 1e-3) runs on its running statistics in ``forward``. Each
module's ``train_forward`` normalizes with the batch moments as flax's
``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` does — ``var = max(0, E[x^2]
- E[x]^2)``, biased — and RETURNS the moments instead of updating the
running statistics: under ``torch.utils.checkpoint`` a block's forward runs
twice, so the caller applies :meth:`BatchNorm.update_running` once per step
(``ra = 0.99 ra + 0.01 batch``, flax's rule, not torch's unbiased one).

``dtype`` is the compute type (float32 or bfloat16), with flax's cast
points: each conv and conv-transpose runs on its input and a view of its
f32 weight cast to ``dtype``; BatchNorm takes its moments of the input in
f32, normalises in f32 (f32 mean, var, scale and bias) and returns
``dtype``. Parameters and running statistics stay f32; in float32 every
cast is a no-op.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


@contextlib.contextmanager
def full_fp32():
    """No TF32 in cuDNN convolutions or cuBLAS matmuls inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def precision(dtype):
    """:func:`full_fp32` for float32, nothing for bfloat16."""
    if dtype == torch.float32:
        return full_fp32()
    if dtype == torch.bfloat16:
        return contextlib.nullcontext()
    raise TypeError(f"compute dtype must be float32 or bfloat16, got {dtype}")


class BatchNorm(nn.Module):
    """BatchNorm over dim 1: trainable scale (``weight``) and ``bias``,
    running statistics as buffers."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        """Running-statistics BatchNorm; the arithmetic runs in f32 and the
        output keeps x's type (a bf16 x takes one mixed-type pass)."""
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)

    def train_forward(self, x, mesh=None):
        """Batch-statistics BatchNorm of (B, C, H, W) x -> (y, mean, var),
        flax's arithmetic in f32 on ``x.float()``: y = (x - mean) *
        (rsqrt(var + eps) * scale) + bias, cast back to x's type; the
        moments are f32. With a ``mesh`` (``parallel.Mesh``) the moments
        E[x] and E[x^2] are averaged over its ranks before the variance,
        as flax's ``BatchNorm(axis_name=)`` pmeans them (sync-BN)."""
        dims = (0, 2, 3)
        xf = x.float()
        mean = xf.mean(dim=dims)
        mean2 = (xf * xf).mean(dim=dims)
        if mesh is not None:
            mean, mean2 = mesh.pmean(torch.cat([mean, mean2])).chunk(2)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype), mean, var

    @torch.no_grad()
    def update_running(self, mean, var) -> None:
        """ra = momentum * ra + (1 - momentum) * batch, for mean and the
        biased var."""
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


class ConvBlock(nn.Module):
    """`layers` x [3x3 conv (padding 1, no bias) + BN + ReLU]; the first
    conv has `stride`."""

    def __init__(self, in_ch: int, channels: int, layers: int,
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.convs = nn.ParameterList(
            [nn.Parameter(torch.zeros(channels, in_ch if i == 0 else channels,
                                      3, 3))
             for i in range(layers)])
        self.bns = nn.ModuleList(BatchNorm(channels) for _ in range(layers))

    def forward(self, x, dtype=torch.float32):
        for i, (w, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.conv2d(x.to(dtype), w.to(dtype),
                         stride=self.stride if i == 0 else 1, padding=1)
            x = torch.relu(bn(x))
        return x

    def train_forward(self, x, dtype=torch.float32, mesh=None):
        """Batch-statistics forward -> (y, mean_0, var_0, mean_1, ...)."""
        moments = []
        for i, (w, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.conv2d(x.to(dtype), w.to(dtype),
                         stride=self.stride if i == 0 else 1, padding=1)
            x, mean, var = bn.train_forward(x, mesh)
            x = torch.relu(x)
            moments += [mean, var]
        return (x, *moments)


class UpBlock(nn.Module):
    """ConvTranspose(k=stride, s=stride, no padding) + BN + ReLU."""

    def __init__(self, in_ch: int, channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(in_ch, channels, stride,
                                               stride))
        self.bn = BatchNorm(channels)

    def forward(self, x, dtype=torch.float32):
        return torch.relu(self.bn(F.conv_transpose2d(
            x.to(dtype), self.weight.to(dtype), stride=self.stride)))

    def train_forward(self, x, dtype=torch.float32, mesh=None):
        y, mean, var = self.bn.train_forward(F.conv_transpose2d(
            x.to(dtype), self.weight.to(dtype), stride=self.stride), mesh)
        return torch.relu(y), mean, var


class DownBlock(nn.Module):
    """An up-stride below 1: Conv(k=1/s, s=1/s, no padding, no bias) + BN +
    ReLU. Its kernel is laid out (out, in, k, k), a convolution's, where
    :class:`UpBlock`'s transposed one is (in, out, k, k)."""

    def __init__(self, in_ch: int, channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(channels, in_ch, stride,
                                               stride))
        self.bn = BatchNorm(channels)

    def forward(self, x, dtype=torch.float32):
        return torch.relu(self.bn(F.conv2d(
            x.to(dtype), self.weight.to(dtype), stride=self.stride)))

    def train_forward(self, x, dtype=torch.float32, mesh=None):
        y, mean, var = self.bn.train_forward(F.conv2d(
            x.to(dtype), self.weight.to(dtype), stride=self.stride), mesh)
        return torch.relu(y), mean, var


def up_block(in_ch: int, channels: int, stride) -> nn.Module:
    """The up path of one block: :class:`UpBlock` for an up-stride of 1 or
    more, :class:`DownBlock` for one below 1 (0.5: a stride-2 conv)."""
    if stride >= 1:
        return UpBlock(in_ch, channels, int(round(stride)))
    return DownBlock(in_ch, channels, int(round(1.0 / stride)))


class RPNBackbone(nn.Module):
    """(B, C_in, H, W) -> (B, 3 * up_channels, H / s, W / s), where block i
    sits at stride 2^(i+1) and ``up_strides[i]`` brings it to the head's
    stride s; the default up-strides 1, 2, 4 give PointPillars' s = 2."""

    def __init__(self, in_ch: int, channels: Sequence[int] = (64, 128, 256),
                 layers: Sequence[int] = (4, 6, 6), up_channels: int = 128,
                 up_strides: Sequence[float] = None):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.ups = nn.ModuleList()
        if up_strides is None:
            up_strides = [2 ** i for i in range(len(channels))]
        prev = in_ch
        for ch, n, s in zip(channels, layers, up_strides):
            self.blocks.append(ConvBlock(prev, ch, n, stride=2))
            self.ups.append(up_block(ch, up_channels, s))
            prev = ch

    def forward(self, x, dtype=torch.float32):
        ups = []
        for block, up in zip(self.blocks, self.ups):
            x = block(x, dtype)
            ups.append(up(x, dtype))
        return torch.cat(ups, dim=1)

    def batch_norms(self) -> List[BatchNorm]:
        """Every BatchNorm in the order :meth:`train_forward` returns their
        moments."""
        out = []
        for block, up in zip(self.blocks, self.ups):
            out += list(block.bns) + [up.bn]
        return out

    def train_forward(self, x, remat: bool = False, dtype=torch.float32,
                      mesh=None):
        """Batch-statistics forward -> (features, moments) with one (mean,
        var) per :meth:`batch_norms` entry, f32 whatever ``dtype``, the
        moments over ``mesh``'s ranks when given. remat checkpoints each
        block: its activations are recomputed (with the same casts, and
        the same collectives on every rank) in the backward pass."""
        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        ups, flat = [], []
        for block, up in zip(self.blocks, self.ups):
            x, *m = run(block.train_forward, x, dtype, mesh)
            flat += m
            u, *m = run(up.train_forward, x, dtype, mesh)
            flat += m
            ups.append(u)
        moments = list(zip(flat[0::2], flat[1::2]))
        return torch.cat(ups, dim=1), moments
