"""The SSD detection head: 1x1 convs over the BEV feature map. Port of
``tpu_pillars/models/head.py`` (``SSDHead``, ``HeadOutputs``,
``feature_major_head``) and of the serving wire head
(``tpu_pillars/detector.py`` ``_wire_head``).

Per feature-map location there are ``anchors_per_loc`` anchors (classes x
yaws). Each anchor predicts ``num_classes`` class logits, a 7-D box
residual and a 2-way direction logit, in the anchor layout of
``ops.anchors`` (row, col, class * yaw).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class HeadOutputs(NamedTuple):
    cls_logits: torch.Tensor   # (B, A, num_classes)
    box_deltas: torch.Tensor   # (B, A, 7)
    dir_logits: torch.Tensor   # (B, A, 2)


class SSDHead(nn.Module):
    """The SSD head's three 1x1 convs, kernels in flax's (C, A_loc * k)
    layout (column = a_loc * k + feature), computed as matmuls in three
    layouts:

    * :meth:`forward`, anchor-major (the flax ``SSDHead``): cls (B, A, K),
      box (B, A, 7), dir (B, A, 2) in CANONICAL anchor order (a = hw *
      A_loc + a_loc);
    * :meth:`wire`, the serving wire: own (B, A) own-class logits in
      canonical order; box_p (B, 7, A) and dir_p (B, 2, A) feature-major in
      the PERMUTED order (a'' = a_loc * HW + hw);
    * :meth:`feature_major`, the training head: cls (B, K, A), box (B, 7,
      A), dir (B, 2, A) in canonical order.

    The three differ only in the order of the products' reductions."""

    def __init__(self, feat_ch: int, num_classes: int, anchors_per_loc: int):
        super().__init__()
        self.k = num_classes
        self.a_loc = anchors_per_loc
        for name, width in (("cls", num_classes), ("box", 7), ("dir", 2)):
            lin = nn.Module()
            lin.weight = nn.Parameter(
                torch.zeros(feat_ch, anchors_per_loc * width))
            lin.bias = nn.Parameter(torch.zeros(anchors_per_loc * width))
            self.add_module(name, lin)
        a_loc = anchors_per_loc
        # own-class channel of anchor a_loc: class a_loc // 2 (2 yaws each)
        self.register_buffer("own_ch", torch.tensor(
            [al * num_classes + al // 2 for al in range(a_loc)]),
            persistent=False)

        def colperm(k_dim):
            # new column (k * A_loc + a_loc) <- old column (a_loc * k + k)
            k = np.arange(k_dim)[:, None]
            al = np.arange(a_loc)[None, :]
            return torch.from_numpy((al * k_dim + k).reshape(-1))

        self.register_buffer("perm_box", colperm(7), persistent=False)
        self.register_buffer("perm_dir", colperm(2), persistent=False)

    def forward(self, feat, dtype=torch.float32) -> HeadOutputs:
        """feat (B, Hf, Wf, C) -> anchor-major :class:`HeadOutputs` in
        ``dtype``: the feature map, kernels and biases cast to ``dtype`` and
        each 1x1 conv one (HW, C) @ (C, A_loc * k) product, reshaped to
        (A, k), as flax's ``nn.Conv(dtype=)`` computes it."""
        B, hf, wf, c = feat.shape
        f = feat.reshape(B, hf * wf, c).to(dtype)

        def conv(lin, k_dim):
            out = f @ lin.weight.to(dtype) + lin.bias.to(dtype)
            return out.reshape(B, -1, k_dim)

        return HeadOutputs(conv(self.cls, self.k), conv(self.box, 7),
                           conv(self.dir, 2))

    def wire(self, feat, dtype=torch.float32):
        """feat (B, Hf, Wf, C) -> (own, box_p, dir_p), f32. The feature map,
        weights and biases are cast to ``dtype`` and the products rounded
        there, as ``_wire_head(dtype=)`` does."""
        B, hf, wf, c = feat.shape
        hw = hf * wf
        a = hw * self.a_loc
        f = feat.reshape(B, hw, c).to(dtype)
        own = (f @ self.cls.weight[:, self.own_ch].to(dtype)
               + self.cls.bias[self.own_ch].to(dtype))
        ft = f.transpose(1, 2)                                 # (B, C, HW)
        box_p = (self.box.weight[:, self.perm_box].t().to(dtype) @ ft
                 + self.box.bias[self.perm_box][:, None].to(dtype))
        dir_p = (self.dir.weight[:, self.perm_dir].t().to(dtype) @ ft
                 + self.dir.bias[self.perm_dir][:, None].to(dtype))
        return (own.reshape(B, a).float(), box_p.reshape(B, 7, a).float(),
                dir_p.reshape(B, 2, a).float())

    def feature_major(self, feat, dtype=torch.float32):
        """The training head: feat (B, Hf, Wf, C) -> (cls (B, K, A),
        box (B, 7, A), dir (B, 2, A)) f32 in CANONICAL anchor order (a = hw
        * A_loc + a_loc). Each output feature k is its own (HW, C) @ (C,
        A_loc) product of the kernel's columns a_loc * k_dim + k, in
        ``dtype``, as ``tpu_pillars/models/head.py`` feature_major_head
        computes it."""
        B, hf, wf, c = feat.shape
        f = feat.reshape(B, hf * wf, c).to(dtype)

        def emit(lin, k_dim):
            outs = []
            for k in range(k_dim):
                cols = torch.arange(self.a_loc, device=feat.device) * k_dim + k
                out_k = (f @ lin.weight[:, cols].to(dtype)
                         + lin.bias[cols].to(dtype))
                outs.append(out_k.reshape(B, -1))
            return torch.stack(outs, dim=1).float()

        return emit(self.cls, self.k), emit(self.box, 7), emit(self.dir, 2)
