"""CenterPoint-PP (Yin, Zhou, Kraehenbuehl, arXiv:2006.11275): the
two-layer PillarFeatureNet, the RPN with up-strides 0.5 / 1 / 2 and the
centre head, as the published nuScenes configuration builds them
(``configs/nusc/pp/nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py`` of
github.com/tianweiy/CenterPoint).

The module holds the weights and runs the dense part; the front end (sort,
K1 emit, K2's two-layer instance, K3 scatter) lives in ``ops`` and takes
the PFN's folded weights (:meth:`TwoLayerPFN.folded`). BatchNorm (eps
1e-3) runs on its running statistics, in float32 under ``full_fp32`` (no
TF32), channels_last, as the PointPillars RPN does. Serving only: the
centre head's training (heatmap targets, focal and L1 losses) is not
ported.

The head holds the published layout, a shared 3x3 conv (bias) + BN + ReLU
and, per task, one branch per output (``reg`` 2, ``height`` 1, ``dim`` 3,
``rot`` 2, ``vel`` 2, ``hm`` one a class): 3x3 conv (bias) + BN + ReLU,
then a 3x3 conv (bias) to the output's width. It runs that arithmetic
in three convolutions (:meth:`CenterHead.stacked`): the shared
conv with its BN folded in, every branch's first conv stacked into one
(all take the shared features; BN folded in), and every branch's second
conv as one grouped conv, each group padded to 3 outputs. The dense maps
then come back in the published concatenation, task after task, each
``reg, height, dim, rot, vel, hm`` (:func:`map_layout`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pillars_torch.config import CenterPointConfig
from tpu_pillars_torch.models.backbone import (
    BN_EPS, BatchNorm, RPNBackbone, full_fp32,
)
from tpu_pillars_torch.ops.bev import scatter_to_bev_auto
from tpu_pillars_torch.ops.fused_pfn import fold_pfn2
from tpu_pillars_torch.ops.voxelize import PillarBatch

GROUP_OUT = 3       # the grouped second conv's outputs a branch (the widest)


def branches(config: CenterPointConfig, task: int) -> List[Tuple[str, int]]:
    """A task's outputs in the published order: the common heads, then its
    heatmap."""
    return list(config.common_heads) + [
        ("hm", len(config.tasks[task].classes))]


def map_layout(config: CenterPointConfig) -> Dict[str, torch.Tensor]:
    """Channel indices of the dense maps (B, sum_t (10 + n_t), H, W) by
    output: {"reg": (T, 2), "height": (T, 1), "dim": (T, 3), "rot": (T, 2),
    "vel": (T, 2), "hm": (T, 2)} long (the heatmap's second column repeats
    its first for a one-class task; :func:`hm_classes` says how many are
    real)."""
    at = 0
    cols = {name: [] for name, _ in config.common_heads}
    cols["hm"] = []
    width = max(len(t.classes) for t in config.tasks)
    for t in range(config.num_tasks):
        for name, n in branches(config, t):
            idx = list(range(at, at + n))
            if name == "hm":
                idx = idx + [idx[0]] * (width - n)
            cols[name].append(idx)
            at += n
    return {k: torch.tensor(v, dtype=torch.long) for k, v in cols.items()}


def map_channels(config: CenterPointConfig) -> int:
    return sum(n for t in range(config.num_tasks)
               for _, n in branches(config, t))


class TwoLayerPFN(nn.Module):
    """The published two-layer PFN: linear D -> C1 (no bias) + BN + ReLU,
    its per-pillar max concatenated to every point (2 C1), linear 2 C1 ->
    C2 + BN + ReLU, the max. C1 is half the first of ``pfn_channels``."""

    def __init__(self, in_dim: int, channels: Tuple[int, int]):
        super().__init__()
        c1, c2 = channels[0] // 2, channels[1]
        self.w1 = nn.Parameter(torch.zeros(in_dim, c1))
        self.bn1 = BatchNorm(c1)
        self.w2 = nn.Parameter(torch.zeros(2 * c1, c2))
        self.bn2 = BatchNorm(c2)

    def folded(self, config: CenterPointConfig):
        """The weights of K2's two-layer instance (``ops.fused_pfn.
        fold_pfn2``)."""
        def bn(m):
            return m.weight, m.bias, m.running_mean, m.running_var

        return fold_pfn2(self.w1, bn(self.bn1), self.w2, bn(self.bn2),
                         config)

    def forward(self, features, mask):
        """Decorated (B, P, N, D) features, (B, P, N) mask -> (B, P, C2).
        As the published PFNLayer: the padded slots are zero rows, and
        both maxima take them in after the layer; 0 for an empty pillar."""
        def layer(x, w, bn):
            y = x @ w
            y = (y - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS)
            return torch.relu(y * bn.weight + bn.bias)

        x = torch.where(mask[..., None], features, 0.0)
        h = layer(x, self.w1, self.bn1)
        m = h.amax(dim=-2, keepdim=True)
        y = layer(torch.cat([h, m.expand_as(h)], dim=-1), self.w2, self.bn2)
        return torch.where(mask.any(dim=-1)[..., None], y.amax(dim=-2), 0.0)


class Branch(nn.Module):
    """One output of a task: 3x3 conv (bias) + BN + ReLU, 3x3 conv (bias)."""

    def __init__(self, channels: int, out: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(channels, channels, 3, 3))
        self.b1 = nn.Parameter(torch.zeros(channels))
        self.bn = BatchNorm(channels)
        self.w2 = nn.Parameter(torch.zeros(out, channels, 3, 3))
        self.b2 = nn.Parameter(torch.zeros(out))


def _fold(w, b, bn: BatchNorm):
    """conv (w, b) then inference BN -> one conv's (w, b)."""
    a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    return w * a[:, None, None, None], (b - bn.running_mean) * a + bn.bias


class CenterHead(nn.Module):
    """The head's weights in the published layout; :meth:`stacked` and
    :meth:`run_stacked` give (B, C_in, H, W) features -> dense maps (B,
    sum_t (10 + n_t), H, W), the published concatenation (module
    docstring)."""

    def __init__(self, in_ch: int, config: CenterPointConfig):
        super().__init__()
        c = config.head_conv
        self.config = config
        self.shared_w = nn.Parameter(torch.zeros(c, in_ch, 3, 3))
        self.shared_b = nn.Parameter(torch.zeros(c))
        self.shared_bn = BatchNorm(c)
        self.tasks = nn.ModuleList(
            nn.ModuleDict({name: Branch(c, n)
                           for name, n in branches(config, t)})
            for t in range(config.num_tasks))

    @torch.no_grad()
    def stacked(self):
        """The serving convolutions: (shared w, b), (first w, b) of every
        branch stacked, (second w, b) as ``groups`` groups of
        ``GROUP_OUT`` outputs, and the index of the published maps among
        the grouped outputs."""
        sw, sb = _fold(self.shared_w, self.shared_b, self.shared_bn)
        w1, b1, w2, b2, index = [], [], [], [], []
        for g, branch in enumerate(b for task in self.tasks
                                   for b in task.values()):
            w, b = _fold(branch.w1, branch.b1, branch.bn)
            w1.append(w)
            b1.append(b)
            n = branch.w2.shape[0]
            pad = GROUP_OUT - n
            w2.append(F.pad(branch.w2, (0, 0, 0, 0, 0, 0, 0, pad)))
            b2.append(F.pad(branch.b2, (0, pad)))
            index += range(g * GROUP_OUT, g * GROUP_OUT + n)
        return ((sw.contiguous(), sb),
                (torch.cat(w1).contiguous(memory_format=torch.channels_last),
                 torch.cat(b1)),
                (torch.cat(w2).contiguous(memory_format=torch.channels_last),
                 torch.cat(b2)),
                torch.tensor(index, dtype=torch.long,
                             device=self.shared_w.device))

    @staticmethod
    def run_stacked(x, weights):
        """The serving arithmetic on channels_last x: three convs, two
        ReLUs and the gather of the published maps (contiguous NCHW)."""
        (sw, sb), (w1, b1), (w2, b2), index = weights
        x = torch.relu(F.conv2d(x, sw, sb, padding=1))
        x = torch.relu(F.conv2d(x, w1, b1, padding=1))
        groups = w1.shape[0] // w2.shape[1]
        x = F.conv2d(x, w2, b2, padding=1, groups=groups)
        return x.index_select(1, index).contiguous()


class CenterPoint(nn.Module):
    """Weights of CenterPoint-PP, with the stages the ``Detector`` runs."""

    def __init__(self, config: CenterPointConfig):
        super().__init__()
        self.config = config
        self.pfn = TwoLayerPFN(config.num_decorated_features,
                               config.pfn_channels)
        self.rpn = RPNBackbone(config.pfn_out, config.rpn_channels,
                               config.rpn_layers, config.rpn_up_channels,
                               config.rpn_up_strides)
        self.head = CenterHead(len(config.rpn_channels)
                               * config.rpn_up_channels, config)

    def canvas_from_batch(self, batch: PillarBatch, dtype=torch.float32):
        """The plain PFN + K3: a decorated ``PillarBatch`` -> (B, H, W, C)
        canvas."""
        feats = self.pfn(batch.features, batch.mask)
        return scatter_to_bev_auto(feats, batch.coords, batch.pillar_mask,
                                   self.config, dtype)

    def features_from_canvas(self, canvas, dtype=torch.float32):
        """(B, H, W, C) canvas -> (B, H / s, W / s, C_feat) features, s the
        head's stride (an NHWC view of the channels_last RPN output)."""
        if dtype != torch.float32:
            raise TypeError("CenterPoint serves in float32")
        x = canvas.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with full_fp32():
            return self.rpn(x).permute(0, 2, 3, 1)

    def head_maps(self, feat, stacked):
        """(B, h, w, C_feat) features -> dense maps (B, sum_t (10 + n_t),
        h, w) through the stacked serving convs (:meth:`CenterHead.
        stacked`)."""
        with full_fp32():
            return CenterHead.run_stacked(feat.permute(0, 3, 1, 2), stacked)
