"""Detection losses, feature-major (and the anchor-major entry,
:func:`detection_loss`): sigmoid focal loss (alpha 0.25, gamma 2)
for classification, smooth-L1 on the 7-D residuals with the
sin(theta_p - theta_t) angle term, and 2-way direction cross-entropy, all
normalized by the positive-anchor count.

Port of ``tpu_pillars/ops/losses.py`` with the same numerics: the
``max(x, 0) - x t + log1p(exp(-|x|))`` cross-entropy, the sin residual, and
``log_softmax`` over the feature axis with a select, not a gather.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.ops.target_assigner import Targets


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    cls: torch.Tensor
    loc: torch.Tensor
    dir: torch.Tensor
    num_pos: torch.Tensor


def sigmoid_focal_loss(logits, targets, alpha: float, gamma: float):
    """Elementwise focal loss. logits, targets: same shape."""
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0.0) - logits * targets
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * (1.0 - p_t) ** gamma * ce


def smooth_l1(x, beta: float = 1.0 / 9.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def detection_loss(cls_logits, box_deltas, dir_logits, targets: Targets,
                   config: PillarsConfig) -> LossBreakdown:
    """Anchor-major inputs cls (..., A, K), box (..., A, 7), dir (..., A, 2)
    (``models.pointpillars.ModelOutputs``): transposed to feature-major,
    then :func:`detection_loss_fm`."""
    return detection_loss_fm(cls_logits.transpose(-1, -2),
                             box_deltas.transpose(-1, -2),
                             dir_logits.transpose(-1, -2), targets, config)


def detection_loss_fm(cls_fm, box_fm, dir_fm, targets: Targets,
                      config: PillarsConfig) -> LossBreakdown:
    """Feature-major inputs cls (..., K, A), box (..., 7, A), dir (..., 2, A)
    and :class:`Targets` with the same leading dims -> per-sample losses
    (each field has the leading dims)."""
    norm = torch.clamp(targets.num_pos, min=1.0)

    cls_el = sigmoid_focal_loss(cls_fm, targets.cls_onehot,
                                config.focal_alpha, config.focal_gamma)
    cls_loss = (cls_el * targets.cls_weights[..., None, :]).sum(
        dim=(-2, -1)) / norm

    reg_t = targets.reg_targets
    diff = box_fm - reg_t
    angle = torch.sin(box_fm[..., 6, :] - reg_t[..., 6, :])
    diff = torch.cat([diff[..., :6, :], angle[..., None, :]], dim=-2)
    loc_el = smooth_l1(diff)
    loc_loss = (loc_el * targets.reg_weights[..., None, :]).sum(
        dim=(-2, -1)) / norm

    logp = torch.log_softmax(dir_fm, dim=-2)
    dir_el = -torch.where(targets.dir_targets == 1, logp[..., 1, :],
                          logp[..., 0, :])
    dir_loss = (dir_el * targets.reg_weights).sum(dim=-1) / norm

    total = (config.pos_weight_cls * cls_loss
             + config.weight_loc * loc_loss
             + config.weight_dir * dir_loss)
    return LossBreakdown(total, cls_loss, loc_loss, dir_loss, targets.num_pos)
