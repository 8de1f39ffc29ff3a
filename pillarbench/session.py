"""One run of one cell: set-up, the measured window, the traced stretch,
the reference and the verdict. :func:`run_cell` returns the result line,
the earlier lines and the checks; ``run.py`` prints them.

The cell's traffic names its loop, ``loops/<loop>.py``, whose ``Loop``
does the work of the run; this module names none. A ``Loop`` is built
as ``Loop(cell, args, device, root, split)``: it makes its weights and
its pool from ``args.seed`` and builds the program, adding the seconds of
each to ``split``. Then:

* ``measure(seconds, trace)`` -> :class:`Window`: warms the cell's shapes
  (set-up), then runs the window; with ``trace`` it profiles a stretch
  of it and takes synchronised spans in the rest;
* ``lines()`` -> earlier lines of the run (truncation counts and such),
  read before the program is freed;
* ``judge()`` -> (the numbers compared, more earlier lines): frees the
  program, runs the reference and compares;
* ``input_counts()`` -> the pool's mean counts for the readers of a
  traced run;
* ``controls(seconds)`` -> {kind: numbers}: the control and the planted
  faults, read by ``control.py`` and never in a run.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time

import numpy as np
import torch

from pillarbench import judge
from pillarbench.readers import RunRecord

PROFILE_MAX_S = 5.0     # a traced run profiles at most this long


@dataclasses.dataclass
class Window:
    """What a loop's window gave: when set-up ended (the window's start,
    host clock), the end-to-end metrics but ``setup_s`` (untraced runs),
    the work attempted and failed, and in a traced run the profiled
    stretch, what it processed, and the spans."""

    t0: float
    e2e: dict
    attempted: int
    failed: int = 0
    profile: object = None
    profiled_items: float = 0.0
    spans: object = None


def profiled_seconds(seconds: float) -> float:
    """How long a traced run profiles of its window."""
    return min(seconds / 2, PROFILE_MAX_S)


def card_facts() -> dict:
    """The card's name, and ``nvidia-smi``'s name, power limit and SM
    clock."""
    out = {"kind": torch.cuda.get_device_name(0), "power_limit": "unknown"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"nvidia-smi failed: {e}"
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(pool, n: int, seed: int) -> set:
    """The inputs whose answers are compared: ``n`` drawn from the seed,
    and the largest."""
    rng = np.random.default_rng([seed, 2])
    n = min(n, len(pool))
    keep = set(int(i) for i in rng.choice(len(pool), n, replace=False))
    sizes = [len(c) if isinstance(c, np.ndarray) else 0 for c in pool]
    keep.add(int(np.argmax(sizes)))
    return keep


def run_cell(cell, args, device, t_start: float, root):
    """-> (result dict, earlier lines, checks)."""
    split = {"torch_and_card": time.perf_counter() - t_start}
    t = time.perf_counter()
    import tpu_pillars_torch  # noqa: F401
    from tpu_pillars_torch import _build

    split["import"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        _build.build_all()
        torch.cuda.reset_peak_memory_stats(device)
    split["kernel_cache"] = time.perf_counter() - t

    loop = cell.loop()(cell, args, device, root, split)
    w = loop.measure(args.seconds, bool(args.trace))
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    lines = loop.lines()
    counts = loop.input_counts() if args.trace else None
    numbers, more = loop.judge()
    del loop
    free()

    facts = card_facts() if device.type == "cuda" else {
        "kind": str(device), "power_limit": "none"}
    lines = [f"card: {facts['kind']}; nvidia-smi name, power limit, SM "
             f"clock (after the window): {facts['power_limit']}",
             "setup split s: " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in split.items())
             ] + lines + more
    correct, checks = judge.verdict(numbers, cell.traffic["limits"])
    metrics = {}
    if args.trace:
        record = RunRecord(cell.config, cell.traffic, spans=w.spans,
                           profile=w.profile,
                           profiled_items=w.profiled_items,
                           input_counts=counts, peak_bytes=peak)
        for m in cell.per_layer:
            v = cell.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(w.e2e, setup_s=w.t0 - t_start)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": facts["kind"], "count": cell.chips,
           "memory_peak_bytes": int(peak or 0)}
    result = {"correct": bool(correct), "attempted": int(w.attempted),
              "failed": int(w.failed), "metrics": metrics, "device": dev}
    if args.trace and w.profile is not None:
        dev["busy_s"] = w.profile.busy_s
        dev["window_s"] = w.profile.window_s
        result["breakdown"] = w.profile.breakdown()
    result["checks"] = checks
    return result, lines, checks
