"""What the per-layer metrics' readers (``pillarbench/metrics/<name>.py``)
share. A reader takes the traced run's record (:class:`RunRecord`) and
returns a number, or None when the run holds nothing for it to read; the
harness then leaves the metric out of the line."""

from __future__ import annotations

import dataclasses
from typing import Optional

from pillarbench.roofline import kernels as K
from pillarbench.roofline import model_flops, peaks


@dataclasses.dataclass
class RunRecord:
    """A traced run: its config and traffic files' contents, the
    synchronised spans, the profiled stretch, what it processed there, per
    call counts of the pool's inputs, and the device's peak
    memory."""

    config: dict
    traffic: dict
    spans: object = None
    profile: object = None
    profiled_items: float = 0.0         # sweeps or samples in the profile
    input_counts: Optional[dict] = None  # per sweep: valid, kept, pillars
    peak_bytes: Optional[int] = None


def span_mean(run: RunRecord, name: str):
    return None if run.spans is None else run.spans.mean(name)


def idle_share(run: RunRecord):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def _dtype(run: RunRecord) -> str:
    return run.config["program"]["dtype"]


def mfu(run: RunRecord, training: bool):
    """Model FLOPs of the items profiled over the profiled seconds, as a
    share of the stated dtype's peak."""
    p, c = run.profile, run.input_counts
    if p is None or c is None or run.profiled_items <= 0:
        return None
    fields = run.config["config"]
    f = model_flops.training_flops if training else model_flops.serving_flops
    flops = f(fields, c["kept"]) * run.profiled_items
    return 100.0 * flops / p.window_s / peaks.OPS_PER_S[_dtype(run)]


def kernel_roofline(run: RunRecord, kernels, gt_per_class: int = 0):
    """Sum over ``kernels`` of calls x bound per call, over their device
    time in the profiled stretch, the bound at the pool's mean counts."""
    p, c = run.profile, run.input_counts
    if p is None or c is None:
        return None
    fields = run.config["config"]
    bound, busy = 0.0, 0.0
    for name, secs in p.kernel_s.items():
        k = K.kernel_of(name)
        if k in kernels:
            busy += secs
    for k in kernels:
        calls = sum(n for name, n in p.launches.items()
                    if K.CALL_NAME[k] in name)
        if not calls:
            continue
        b = run.traffic["batch"]
        if k == "K1":
            nb, ops = K.k1(fields, b, c["valid"] * b)
        elif k == "K2":
            nb, ops = K.k2(fields, b, c["kept"] * b)
        elif k == "K3":
            nb, ops = K.k3(fields, b, c["pillars"] * b)
        elif k == "K4":
            nb, ops = K.k4(fields, b)
        else:
            nb, ops = K.k5(fields, b, gt_per_class)
        bound += calls * peaks.bound_s(nb, ops, _dtype(run))
    if busy <= 0:
        return None
    return 100.0 * bound / busy
