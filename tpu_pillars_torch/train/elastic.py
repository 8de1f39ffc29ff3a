"""Failure detection and preemption recovery for training. Port of
``tpu_pillars/train/elastic.py`` (host-side control plane, no device code):

  * preemption: maintenance events deliver SIGTERM. :class:`GracefulShutdown`
    turns it into a flag the fit loop polls once per step, so the run
    checkpoints its exact state and exits 0; ``--resume`` then replays the
    seeded data stream and continues the same loss curve.
  * divergence: a silent NaN or overflow poisons every later step.
    :class:`NaNGuard` checks the loss where it is on the host anyway (the
    logging cadence), keeps a copy of the last finite state, and on
    divergence saves that copy as a full checkpoint before raising
    :class:`TrainingDiverged`: the forensic artifact is the state BEFORE the
    poison step. The port's ``TrainState`` is updated in place, so the copy
    is a :meth:`TrainState.clone` on the device, not a reference.
  * stalls: a hung step stalls the single controller, so one
    :class:`Heartbeat` file covers the run. The fit loop beats every step;
    a supervisor (:func:`check_heartbeat`) flags a run whose file has gone
    quiet and can kill and restart it through the preemption path above.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time
from typing import Optional


class GracefulShutdown:
    """Context manager: converts SIGTERM (and optionally SIGINT) into a
    polled flag. Re-raising semantics: the previous handler is restored on
    exit; a second signal while shutdown is already pending falls through
    to the previous handler (so a stuck run can still be hard-killed)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self.requested = False

    def _handler(self, signum, frame):
        if self.requested:                      # second signal: escalate
            prev = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            os.kill(os.getpid(), signum)
            return
        self.requested = True

    def __enter__(self):
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        return False

    def __call__(self) -> bool:
        return self.requested


class Heartbeat:
    """Atomic single-line JSON heartbeat: {"step": N, "time": unix_s}.
    One write + rename per beat — cheap enough for every step, safe for a
    concurrent reader."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"step": int(step), "time": time.time()}))
        os.replace(tmp, self.path)


def check_heartbeat(path: str, stall_after_s: float) -> dict:
    """Supervisor-side stall check. Returns
    {"status": "missing"|"ok"|"stalled", "age_s": float, "step": int}."""
    try:
        with open(path) as f:
            rec = json.loads(f.read())
    except (FileNotFoundError, json.JSONDecodeError):
        return {"status": "missing", "age_s": math.inf, "step": -1}
    age = time.time() - float(rec.get("time", 0.0))
    return {
        "status": "stalled" if age > stall_after_s else "ok",
        "age_s": age,
        "step": int(rec.get("step", -1)),
    }


class TrainingDiverged(RuntimeError):
    """Raised by NaNGuard; .diagnostic_path points at the last-finite-state
    checkpoint (None if no finite state was ever observed)."""

    def __init__(self, msg: str, diagnostic_path: Optional[str]):
        super().__init__(msg)
        self.diagnostic_path = diagnostic_path


class NaNGuard:
    """Divergence detector. Call ``observe(state, loss)`` whenever the loss
    is on host anyway (the logging cadence — checking every step would force
    an extra device sync); keeps a clone of the last finite state (one copy
    of the parameters, statistics and moments on the device)."""

    def __init__(self, diagnostic_path: Optional[str] = None, config=None):
        self.diagnostic_path = diagnostic_path
        self.config = config
        self._last_finite_state = None
        self._last_finite_step = -1

    def observe(self, state, loss: float) -> None:
        if math.isfinite(loss):
            self._last_finite_state = None       # free the old copy first
            self._last_finite_state = state.clone()
            self._last_finite_step = int(state.step)
            return
        saved = None
        if self.diagnostic_path and self._last_finite_state is not None:
            from tpu_pillars_torch.train.checkpoint import save_checkpoint

            save_checkpoint(self.diagnostic_path, self._last_finite_state,
                            config=self.config)
            saved = self.diagnostic_path
        raise TrainingDiverged(
            f"non-finite loss {loss!r} at step {int(state.step)} "
            f"(last finite state: step {self._last_finite_step}"
            f"{', saved to ' + saved if saved else ''})",
            diagnostic_path=saved)
