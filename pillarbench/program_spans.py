"""What the readers of the program's own spans share: the totals of
``tpu_pillars_torch.utils.profiling.summary()``, which the program records
while a profiler records, so in a traced run's profiled stretch and only
there. A reader returns a mean per unit (``detector.predict``, a batch;
``fit.step``, a training step) over that stretch, or None where the
program recorded nothing for it: a program without the recorder, a span
that never ran, or device times on the CPU."""

from __future__ import annotations


def summary(run):
    """The program's summary, read once a run (it synchronises the card);
    None where the program has no recorder."""
    if not hasattr(run, "program_spans"):
        try:
            from tpu_pillars_torch.utils import profiling
        except ImportError:
            profiling = None
        read = getattr(profiling, "summary", None)
        run.program_spans = None if read is None else read()["spans"]
    return run.program_spans


def _units(spans, unit):
    n = spans.get(unit, {}).get("count", 0)
    return n or None


def per_unit(run, unit: str, name: str, field: str = "host_ms",
             absent=None):
    """``field`` of span ``name`` summed over the stretch, over the units
    of span ``unit``; ``absent`` where units ran but span ``name`` did
    not."""
    spans = summary(run)
    n = _units(spans or {}, unit)
    if n is None:
        return None
    if name not in spans:
        return absent
    v = spans[name][field]
    return None if v is None else v / n


def step_host_ms(run, unit: str, less: tuple):
    """The host ms of a unit span less those of the spans ``less`` inside
    it, a unit."""
    spans = summary(run)
    n = _units(spans or {}, unit)
    if n is None:
        return None
    return (spans[unit]["host_ms"] - sum(spans[k]["host_ms"] for k in less
                                          if k in spans)) / n


def gap_ms(run, unit: str):
    """The unit's mean gap: the device ms from the end of one unit to the
    start of the next, over the gaps recorded."""
    spans = summary(run)
    if not spans or unit not in spans or spans[unit]["gap_ms"] is None:
        return None
    return spans[unit]["gap_ms"] / spans[unit]["gaps"]
