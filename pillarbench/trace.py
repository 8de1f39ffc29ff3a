"""What a traced run records: host-clock spans taken by the benchmark
around its calls into each layer, and a summary of a
``torch.profiler`` window kept in memory (no trace file is written).

Spans are the benchmark's own: the program is not instrumented. A span
with ``sync`` waits for the card at both ends, so it holds the layer's
device work; that perturbs the pipelining, so the traced run takes its
spans apart from the profiled part of its window.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    """Durations in ms by name."""

    def __init__(self):
        self.ms = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        sync = sync and torch.cuda.is_available()
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize()
            self.ms[name].append((time.perf_counter() - t) * 1e3)

    def mean(self, name: str):
        v = self.ms.get(name)
        return sum(v) / len(v) if v else None


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _interval_union(intervals):
    """Total length of the union of (start, end) intervals."""
    total = 0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class DeviceProfile:
    """A profiled stretch of the window: the card's activity (kernels,
    copies, sets) as read from the profiler's events, and the host labels
    the benchmark put around its calls (``torch.profiler.record_function``).

    After :meth:`stop`: ``window_s`` (host clock, from start to a
    synchronised stop), ``busy_s`` (the union of device activity inside it),
    ``kernel_s`` ({name: device seconds}), ``launches`` ({name: count}),
    ``idle_gaps`` ([(host label, seconds)] for every gap between device
    activity, labelled by the host label that covers its middle)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self):
        _sync()
        self._prof.__enter__()
        self._t0_host = time.perf_counter()
        return self

    def stop(self):
        _sync()
        self.window_s = time.perf_counter() - self._t0_host
        self._prof.__exit__(None, None, None)
        self._summarise()
        del self._prof
        return self

    def _summarise(self):
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        dev, labels = [], []
        self.kernel_s = defaultdict(float)
        self.launches = defaultdict(int)
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                s, d = e.start_ns(), e.duration_ns()
                dev.append((s, s + d))
                self.kernel_s[e.name()] += d * 1e-9
                self.launches[e.name()] += 1
            elif e.is_user_annotation() and e.name().startswith("pb."):
                s = e.start_ns()
                labels.append((s, s + e.duration_ns(), e.name()[3:]))
        self.busy_s = _interval_union(dev) * 1e-9
        self.idle_gaps = []
        dev.sort()
        end = None
        for s, e in dev:
            if end is not None and s > end:
                mid = (s + end) / 2
                covering = [lab for a, b, lab in labels if a <= mid <= b]
                label = covering[-1] if covering else "other"
                self.idle_gaps.append((label, (s - end) * 1e-9))
            end = e if end is None else max(end, e)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle
        seconds summed by the host label, the ten largest."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        idle = defaultdict(float)
        for label, s in self.idle_gaps:
            idle[label] += s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def label(name: str):
    """A host label for the profiler's idle gaps (``pb.<name>``)."""
    return torch.profiler.record_function("pb." + name)
