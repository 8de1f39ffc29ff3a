"""Exponential moving average of the model parameters. Port of
``tpu_pillars/train/ema.py``.

Evaluating or serving the EMA of the weights instead of the last iterate
smooths optimizer noise. The tracker stays outside the training step: one
multi-tensor pass over the parameter list after each step, and the step and
its checkpoints are the same whether EMA is on or off.

BatchNorm running statistics are already EMAs of batch moments, so the
tracker averages the parameters only and serves the LATEST statistics
beside them (:meth:`EmaTracker.swap_into`).

Decay warmup (default on): the effective decay at update n (1-based) is
``min(decay, (1 + n) / (10 + n))``, so that the early EMA is close to a
running mean and short runs do not serve the random init; ``warmup=False``
keeps the decay fixed.
"""

from __future__ import annotations

import copy
from typing import Iterable, Optional

import numpy as np
import torch


class EmaTracker:
    """decay=0.999: ~1000-step averaging horizon (once past warmup).
    Initialized at the first iterate (no zero-debias needed)."""

    def __init__(self, params: Iterable[torch.Tensor], decay: float = 0.999,
                 warmup: bool = True):
        if not (0.0 < decay < 1.0):
            raise ValueError(f"decay must be in (0, 1); got {decay}")
        self.decay = float(decay)
        self.warmup = bool(warmup)
        self.count = 0
        self.params = [p.detach().clone() for p in params]
        self._view = None

    def _decay_at(self, n: int) -> float:
        """Effective decay for 1-based update n."""
        if not self.warmup:
            return self.decay
        return min(self.decay, (1.0 + n) / (10.0 + n))

    @torch.no_grad()
    def update(self, params: Iterable[torch.Tensor]) -> None:
        """``e = e * d + p * (1 - d)`` in float32, with ``d`` and ``1 - d``
        rounded to float32 as the JAX tracker's traced scalar gives them:
        two products and a sum, each rounded once (``torch.lerp`` rounds
        otherwise)."""
        self.count += 1
        d = np.float32(self._decay_at(self.count))
        scaled = torch._foreach_mul([p.detach() for p in params],
                                    float(np.float32(1.0) - d))
        torch._foreach_mul_(self.params, float(d))
        torch._foreach_add_(self.params, scaled)

    @torch.no_grad()
    def swap_into(self, state):
        """A ``TrainState`` view for evaluation and export: a model (made
        once, then reused) that carries the EMA parameters and ``state``'s
        live BatchNorm statistics, ``state.step``, and no optimizer. The
        training model and its optimizer are untouched. Do NOT resume
        training from it: ``save_checkpoint`` cannot write it."""
        from tpu_pillars_torch.train.state import TrainState

        if self._view is None:
            self._view = copy.deepcopy(state.model).requires_grad_(False)
        view = self._view
        torch._foreach_copy_(list(view.parameters()), self.params)
        torch._foreach_copy_(list(view.buffers()),
                             list(state.model.buffers()))
        return TrainState(view, None, state.step)


def maybe_tracker(params: Iterable[torch.Tensor], decay: float
                  ) -> Optional[EmaTracker]:
    """CLI helper: decay <= 0 disables EMA."""
    return EmaTracker(params, decay) if decay and decay > 0.0 else None
