"""Train state: the model (parameters + BatchNorm running statistics), the
optimizer and the step counter. Port of ``tpu_pillars/train/state.py``.

The optimizer reproduces the JAX package's ``optax.chain(
clip_by_global_norm(max_norm), adamw(schedule, weight_decay))`` exactly:

  * clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
    as ``(g / norm) * max_norm``, with no epsilon (``clip_grad_norm_``
    differs);
  * AdamW decays EVERY parameter, biases and BatchNorm scales included:
    ``p -= lr(count) * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p)``;
  * the schedule is linear warmup lr/25 -> lr over ``max(1, round(total *
    warmup_frac))`` steps, then cosine decay to ``1e-4 * lr``, evaluated at
    the step count BEFORE the increment (step 0 uses lr/25).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.models.pointpillars import PointPillars
from tpu_pillars_torch.weights import flax_from_params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    grad_clip_norm: float = 10.0
    total_steps: int = 10000
    warmup_frac: float = 0.1
    max_gt_boxes: int = 64   # static GT padding per sweep
    batch_size: int = 8
    # "float32" or "bfloat16": model-activation dtype for the train step
    # (make_train_step(compute_dtype=)); the master state stays float32
    compute_dtype: str = "float32"


def learning_rate(tcfg: TrainConfig, count: int) -> float:
    """The schedule at optimizer step ``count`` (0-based), in float32 as
    optax evaluates it."""
    f32 = np.float32
    lr = f32(tcfg.learning_rate)
    warmup = max(1, int(round(tcfg.total_steps * tcfg.warmup_frac)))
    decay = max(1, tcfg.total_steps - warmup)
    # Python-float constants fold in double and round once, as JAX's weak
    # typing does
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        span = f32(tcfg.learning_rate / 25.0 - tcfg.learning_rate)
        return float(span * frac + lr)
    t = f32(min(float(count - warmup), float(decay)))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay)))
    alpha = 1e-4
    return float(lr * (f32(1.0 - alpha) * cosine + f32(alpha)))


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw(schedule))`` over a fixed
    list of parameters (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.nn.Parameter], tcfg: TrainConfig):
        self.params = list(params)
        self.tcfg = tcfg
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None
             ) -> torch.Tensor:
        """One update from ``grads`` (default each parameter's ``.grad``).
        Returns the global gradient norm before clipping (a 0-d tensor, so
        the step needs no host sync)."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        max_norm = self.tcfg.grad_clip_norm
        keep = norm < max_norm
        grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
        count_inc = self.count + 1
        b1, b2 = self.b1, self.b2
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count_inc))
        lr = learning_rate(self.tcfg, self.count)
        wd = self.tcfg.weight_decay
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + wd * p
            p.add_((-lr) * u)
        self.count = count_inc
        return norm

    def state_arrays(self) -> dict:
        """``{"count": int, "mu": [tensor], "nu": [tensor]}``: the state a
        resume needs, the live moment tensors in parameter order (optax's
        ``ScaleByAdamState``; its schedule count equals ``count``)."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_arrays(self, arrays: dict) -> None:
        """Copy :meth:`state_arrays`-shaped moments (tensors or numpy, any
        device) into this optimizer's, bit for bit, and take its count."""
        for name in ("mu", "nu"):
            dst, src = getattr(self, name), arrays[name]
            if len(src) != len(dst):
                raise ValueError(f"{name}: {len(src)} moments for "
                                 f"{len(dst)} parameters")
            for d, x in zip(dst, src):
                x = torch.as_tensor(x)
                if x.shape != d.shape:
                    raise ValueError(f"{name}: a moment of shape "
                                     f"{tuple(x.shape)} for a parameter of "
                                     f"shape {tuple(d.shape)}")
                d.copy_(x)
        self.count = int(arrays["count"])


@dataclasses.dataclass
class TrainState:
    """The model (updated in place by the step), its optimizer and the
    number of optimizer steps taken. ``optimizer`` is None on a view that
    must not be trained or resumed from (``EmaTracker.swap_into``)."""

    model: PointPillars
    optimizer: Optional[AdamW]
    step: int = 0

    @property
    def variables(self) -> dict:
        """The JAX ``TrainState.variables``: {'params', 'batch_stats'} as
        flax-shaped numpy trees, copied off the device."""
        return flax_from_params(self.model.state_dict(), self.model.config)

    def clone(self) -> "TrainState":
        """A copy on the same device that later steps of this state do not
        touch: parameters, running statistics, moments, count and step."""
        model = copy.deepcopy(self.model)
        optimizer = AdamW(model.parameters(), self.optimizer.tcfg)
        optimizer.load_state_arrays(self.optimizer.state_arrays())
        return TrainState(model, optimizer, self.step)


def init_parameters(model: PointPillars, generator: torch.Generator) -> None:
    """flax's default initializers, drawn from ``generator``: kernels
    lecun-normal (truncated normal, std sqrt(1 / fan_in) / 0.8796 within
    +-2 std), biases 0, BatchNorm scale 1, running statistics (0, 1)."""
    def lecun(t, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            t.copy_(torch.nn.init.trunc_normal_(
                torch.empty(t.shape), 0.0, std, -2.0 * std, 2.0 * std,
                generator=generator))

    for name, p in model.named_parameters():
        if name == "pfn.kernel" or (name.startswith("head.")
                                    and name.endswith(".weight")):
            lecun(p, p.shape[0])                     # flax (in, out) layout
        elif p.dim() == 4:
            # conv (out, in, kh, kw) / conv-transpose (in, out, kh, kw)
            in_ch = p.shape[0] if ".ups." in name else p.shape[1]
            lecun(p, in_ch * p.shape[2] * p.shape[3])
        elif name.endswith(".weight"):
            with torch.no_grad():
                p.fill_(1.0)
        else:
            with torch.no_grad():
                p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)


def create_train_state(config: PillarsConfig, tcfg: TrainConfig,
                       seed: int = 0, device=None,
                       state_dict: Optional[dict] = None) -> TrainState:
    """A fresh model (random from ``seed``, or ``state_dict``, e.g.
    ``weights.params_from_flax`` of a checkpoint) with a fresh optimizer,
    on ``device`` (the card unless the CPU is asked for)."""
    from tpu_pillars_torch.detector import resolve_device

    if tcfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {tcfg.compute_dtype!r}")
    device = resolve_device(device)
    model = PointPillars(config)
    if state_dict is None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model = model.to(device)
    return TrainState(model, AdamW(model.parameters(), tcfg))
