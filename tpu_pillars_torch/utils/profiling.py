"""Profiling — port of ``tpu_pillars/utils/profiling.py``, and the port's
one span recorder.

The recorder: :func:`span` (a context manager), :func:`count` (a
counter), :func:`count_device` (a counter of a device scalar, read
without a synchronise), :func:`summary`, :func:`records`, :func:`reset`. It records while
a ``torch.profiler`` records, or between :func:`enable` and
:func:`disable`, and at no other time: off, a span is one check and a
shared no-op context (no CUDA event, no ``record_function``). On, a span

* opens ``torch.profiler.record_function("tp." + name)`` while a profiler
  records, so that it lies in the profiler's trace on the clock of the
  kernels and copies;
* keeps a record (name, host start and end in ns, its parent span, its
  unit) in a bounded buffer, and adds to its name's totals: count, host
  ms, host self ms (the span less its children);
* with ``device`` (True, or a CUDA ``torch.device``), records a CUDA event
  from a pool on the current stream at each end and never synchronises.
  A pair is resolved once its end event has completed, or in
  :func:`summary`, which synchronises once before it reads them.

A unit span (``unit=True``: a batch, a step) numbers the spans inside it,
and with ``device`` records its gap: the device ms from the end of the
previous unit of its name to its own start, the card's idle time between
units as the program sees it. A gap is counted only between two units
that were both recorded.

``StageTimer`` (a stage timer that synchronises the device of what each
stage observed) and the training step's ``split=`` are front ends of the
same :class:`Recorder`; ``trace`` writes a ``torch.profiler`` trace file,
which holds the ``tp.`` spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import torch

RECORDS = 1 << 16       # the record buffer keeps the newest spans

_profiler_enabled = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_enabled = False


class _Frame:
    """An open span."""

    __slots__ = ("name", "parent", "unit", "is_unit", "device", "children",
                 "annotation", "ev0", "t0")


class _Totals:
    __slots__ = ("count", "host_ns", "self_ns", "device_ms", "device_n",
                 "gap_ms", "gaps")

    def __init__(self):
        self.count = self.host_ns = self.self_ns = 0
        self.device_ms, self.device_n = 0.0, 0
        self.gap_ms, self.gaps = 0.0, 0

    def as_dict(self) -> dict:
        return {"count": self.count, "host_ms": self.host_ns * 1e-6,
                "self_ms": self.self_ns * 1e-6,
                "device_ms": self.device_ms if self.device_n else None,
                "gap_ms": self.gap_ms if self.gaps else None,
                "gaps": self.gaps}


class Span:
    """A span of a :class:`Recorder` as a context manager; ``host_ms``
    after it closes."""

    __slots__ = ("recorder", "name", "device", "unit", "frame", "host_ms")

    def __init__(self, recorder, name, device, unit):
        self.recorder, self.name = recorder, name
        self.device, self.unit = device, unit

    def __enter__(self):
        self.frame = self.recorder.open(self.name, self.device, self.unit)
        return self

    def __exit__(self, *exc):
        self.host_ms = self.recorder.close(self.frame) * 1e-6
        return False


class Recorder:
    """Spans and counters in memory. Every span of a recorder records; the
    module's functions record into one of them while tracing is on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool = defaultdict(list)      # device -> free CUDA events
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.records = deque(maxlen=RECORDS)
            self.totals: Dict[str, _Totals] = {}
            self.counters: Dict[str, float] = defaultdict(int)
            self._pending = deque()
            self._last_end = {}     # (unit name, device) -> its end event
            self._units = 0
            self._counts = deque()  # (name, pinned host value, event)

    def span(self, name: str, device: Optional[torch.device] = None,
             unit: bool = False) -> Span:
        """``device``: a CUDA device whose current stream the span's events
        go on, or None for a host span."""
        return Span(self, name, device, unit)

    def break_units(self) -> None:
        """The next unit of each name has no gap: the one before it was
        not recorded."""
        self._last_end.clear()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _event(self, device):
        try:
            ev = self._pool[device].pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def open(self, name: str, device=None, unit: bool = False) -> _Frame:
        stack = self._stack()
        parent = stack[-1] if stack else None
        f = _Frame()
        f.name, f.is_unit, f.device, f.children = name, unit, device, 0
        f.parent = None if parent is None else parent.name
        if unit:
            with self._lock:
                self._units += 1
                f.unit = self._units
        else:
            f.unit = None if parent is None else parent.unit
        f.annotation = None
        if _profiler_enabled():
            f.annotation = torch.profiler.record_function("tp." + name)
            f.annotation.__enter__()
        f.ev0 = None if device is None else self._event(device)
        stack.append(f)
        f.t0 = time.perf_counter_ns()
        return f

    def close(self, f: _Frame) -> int:
        """Closes the innermost open span ``f``; returns its host ns."""
        t1 = time.perf_counter_ns()
        ev1 = None if f.ev0 is None else self._event(f.device)
        if f.annotation is not None:
            f.annotation.__exit__(None, None, None)
        stack = self._stack()
        stack.pop()
        ns = t1 - f.t0
        if stack:
            stack[-1].children += ns
        with self._lock:
            self.records.append((f.name, f.t0, t1, f.parent, f.unit))
            tot = self.totals.get(f.name)
            if tot is None:
                tot = self.totals[f.name] = _Totals()
            tot.count += 1
            tot.host_ns += ns
            tot.self_ns += ns - f.children
            if ev1 is not None:
                prev = None
                if f.is_unit:
                    key = (f.name, f.device)
                    prev = self._last_end.get(key)
                    self._last_end[key] = ev1
                self._pending.append((tot, f.ev0, ev1, prev, f.is_unit,
                                      f.device))
                self._resolve(wait=False)
        return ns

    def _resolve(self, wait: bool) -> None:
        """Reads the device times of pending pairs, oldest first: those
        whose events have completed, or (``wait``, after a synchronise)
        all. A unit's end event stays out of the pool until the next unit
        has read its gap from it."""
        pending = self._pending
        while pending:
            tot, ev0, ev1, prev, is_unit, device = pending[0]
            if not wait and not (ev1.query() and ev0.query()
                                 and (prev is None or prev.query())):
                return
            pending.popleft()
            tot.device_ms += ev0.elapsed_time(ev1)
            tot.device_n += 1
            pool = self._pool[device]
            if prev is not None:
                tot.gap_ms += prev.elapsed_time(ev0)
                tot.gaps += 1
                pool.append(prev)
            pool.append(ev0)
            if not is_unit:
                pool.append(ev1)

    def count(self, name: str, n=1) -> None:
        with self._lock:
            self.counters[name] += n

    def count_device(self, name: str, value: torch.Tensor) -> None:
        """Adds the 0-d tensor ``value`` to the counter ``name`` without a
        synchronise: on a card it crosses to pinned host memory behind an
        event and is added once the event has completed, or in
        :meth:`summary`."""
        if value.device.type != "cuda":
            self.count(name, value.item())
            return
        host = torch.empty((), dtype=value.dtype, pin_memory=True)
        host.copy_(value, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(value.device))
        with self._lock:
            self._counts.append((name, host, ev))
            self._add_counts(wait=False)

    def _add_counts(self, wait: bool) -> None:
        """Adds the device counts whose copies are done (``wait``: all,
        waiting for each), oldest first; under the lock."""
        while self._counts:
            name, host, ev = self._counts[0]
            if wait:
                ev.synchronize()
            elif not ev.query():
                return
            self._counts.popleft()
            self.counters[name] += host.item()

    def summary(self) -> dict:
        """{"spans": {name: {"count", "host_ms", "self_ms", "device_ms",
        "gap_ms", "gaps"}}, "counters": {name: total}}: totals since the
        last reset; ``device_ms`` and ``gap_ms`` are None where the span
        has none. Synchronises each card with pending events, once, before
        it reads them."""
        with self._lock:
            if self._pending:
                for device in {p[5] for p in self._pending}:
                    torch.cuda.synchronize(device)
                self._resolve(wait=True)
            self._add_counts(wait=True)
            return {"spans": {k: t.as_dict() for k, t in self.totals.items()},
                    "counters": dict(self.counters)}


_RECORDER = Recorder()


def recording() -> bool:
    """Whether the module's spans record now."""
    return _enabled or _profiler_enabled()


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records."""
    global _enabled
    _enabled = False
    _RECORDER.break_units()


def _cuda_device(device) -> Optional[torch.device]:
    """A span's ``device`` argument -> the CUDA device its events go on, or
    None (host only: False, or a device that is not a card's)."""
    if device is False or device is None:
        return None
    if device is True:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def span(name: str, device=False, unit: bool = False):
    """A span of the program while tracing is on, else a shared no-op.
    ``device``: True for the current card, or the ``torch.device`` of the
    work (a CPU device records host time alone). ``unit``: a batch or a
    step, whose gap from the previous one is recorded."""
    if _enabled or _profiler_enabled():
        return _RECORDER.span(name, _cuda_device(device), unit)
    if unit and _RECORDER._last_end:
        _RECORDER.break_units()
    return _NOOP


def count(name: str, n=1) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on."""
    if _enabled or _profiler_enabled():
        _RECORDER.count(name, n)


def count_device(name: str, value: torch.Tensor) -> None:
    """Adds the 0-d tensor ``value`` to the counter ``name`` while tracing
    is on, without a synchronise (:meth:`Recorder.count_device`). A caller
    computes ``value`` only while :func:`recording`, so that the card does
    no work for it otherwise."""
    if _enabled or _profiler_enabled():
        _RECORDER.count_device(name, value)


def summary() -> dict:
    """The module recorder's totals (:meth:`Recorder.summary`)."""
    return _RECORDER.summary()


def records() -> list:
    """The newest spans, oldest first: (name, host start ns, host end ns,
    parent name or None, unit number or None)."""
    with _RECORDER._lock:
        return list(_RECORDER.records)


def reset() -> None:
    """Clears the module recorder's spans, totals and counters."""
    _RECORDER.reset()


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
    """Accumulates per-stage wall time with device-synced boundaries, on a
    :class:`Recorder` of its own.

    ``stage`` syncs on the device of the tensors the stage registered with
    ``observe``: ``torch.cuda.synchronize`` of that card for a CUDA tensor,
    nothing for a CPU tensor (CPU ops have finished when they return). A
    stage that registers nothing is timed on the host clock alone.

    >>> timer = StageTimer()
    >>> with timer.stage("canvas"):
    ...     timer.observe(det.canvas(points, counts))   # sync on exit
    >>> timer.summary()   # {'canvas': {'total_s': ..., 'count': ..., ...}}
    """

    def __init__(self):
        self._spans = Recorder()
        self._result = None

    def observe(self, tree):
        """Register the stage's output so the timer can sync on it."""
        self._result = tree
        return tree

    @contextlib.contextmanager
    def stage(self, name: str):
        frame = self._spans.open(name)
        try:
            yield self
        finally:
            if self._result is not None:
                _sync(self._result)
                self._result = None
            self._spans.close(frame)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v["host_ms"] * 1e-3, 6), "count": v["count"],
                "mean_ms": round(v["host_ms"] / max(v["count"], 1), 3)}
            for k, v in self._spans.summary()["spans"].items()
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``:
    the host's activity with the program's ``tp.`` spans, and the card's
    (kernels and copies, by CUPTI) when there is one. On exit the trace is
    written as ``log_dir/<host>_<pid>.<time>.pt.trace.json`` (Chrome trace
    format: TensorBoard's profiler plugin and Perfetto read it; see
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
