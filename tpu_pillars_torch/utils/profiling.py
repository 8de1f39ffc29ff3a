"""Profiling helpers — port of ``tpu_pillars/utils/profiling.py``: wall-clock
stage timers with a device sync at each boundary, and a ``torch.profiler``
trace context that writes a trace TensorBoard or Perfetto can read.

``StageTimer`` syncs on the device of the tensors a stage registered with
``observe``: ``torch.cuda.synchronize`` of that card for a CUDA tensor,
nothing for a CPU tensor (CPU ops have finished when they return). A stage
that registers nothing is timed on the host clock alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


def _tensors(tree):
    """The tensors in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _sync(tree) -> None:
    """Wait for the device work behind every CUDA tensor of ``tree``: one
    ``torch.cuda.synchronize`` per card they lie on."""
    cards = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for d in cards:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates per-stage wall time with device-synced boundaries.

    >>> timer = StageTimer()
    >>> with timer.stage("canvas"):
    ...     timer.observe(det.canvas(points, counts))   # sync on exit
    >>> timer.summary()   # {'canvas': {'total_s': ..., 'count': ..., ...}}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._result = None

    def observe(self, tree):
        """Register the stage's output so the timer can sync on it."""
        self._result = tree
        return tree

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self._result is not None:
                _sync(self._result)
                self._result = None
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 6), "count": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``:
    the host's activity, and the card's (kernels and copies, by CUPTI)
    when there is one. On exit the trace is written as
    ``log_dir/<host>_<pid>.<time>.pt.trace.json`` (Chrome trace format:
    TensorBoard's profiler plugin and Perfetto read it; see
    :func:`trace_files`). Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` hold the same events."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def trace_files(log_dir: str) -> List[str]:
    """The trace files :func:`trace` wrote under ``log_dir``, oldest
    first."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")),
                  key=os.path.getmtime)
