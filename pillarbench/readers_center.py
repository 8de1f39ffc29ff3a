"""What the CenterPoint cells' readers share beyond ``readers`` and
``program_spans``: a program counter a cloud, the whole step's share of
the f32 peak, and kernels against their roofline at this configuration's
counts (``roofline.centerpoint``)."""

from __future__ import annotations

from pillarbench.program_spans import summary
from pillarbench.roofline import centerpoint as C
from pillarbench.roofline import peaks


def counter_per_cloud(run, name: str, unit: str = "detector.predict"):
    """The program counter ``name`` over the profiled stretch, a cloud
    (units of span ``unit`` times the batch); None where the program
    records no such counter."""
    spans = summary(run)
    if not spans or not spans.get(unit, {}).get("count"):
        return None
    from tpu_pillars_torch.utils import profiling

    counters = profiling.summary().get("counters", {})
    if name not in counters:
        return None
    return counters[name] / (spans[unit]["count"] * run.traffic["batch"])


def mfu(run):
    """Model FLOPs of the clouds served in the profiled stretch over its
    seconds, % of the f32 peak."""
    p, c = run.profile, run.input_counts
    if p is None or c is None or run.profiled_items <= 0:
        return None
    flops = C.serving_flops(run.config["config"], c["kept"]) \
        * run.profiled_items
    return 100.0 * flops / p.window_s / peaks.OPS_PER_S["float32"]


def kernel_roofline(run, kernels):
    """Sum over ``kernels`` of calls x bound per call, over their device
    time in the profiled stretch, %; None where none of them ran."""
    p, c = run.profile, run.input_counts
    if p is None or c is None:
        return None
    fields, batch = run.config["config"], run.traffic["batch"]
    busy = sum(s for name, s in p.kernel_s.items()
               if C.kernel_of(name) in kernels)
    bound = 0.0
    for k in kernels:
        calls = sum(n for name, n in p.launches.items()
                    if C.CALL_NAME[k] in name)
        if calls:
            bound += calls * peaks.bound_s(
                *C.kernel_bound(k, fields, batch, c), "float32")
    if busy <= 0:
        return None
    return 100.0 * bound / busy
