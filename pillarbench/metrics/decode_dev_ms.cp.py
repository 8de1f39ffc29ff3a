"""The device ms of a batch's heatmap decode and per-task top-1,000,
pipelined and unsynchronised: the program's span ``detector.decode``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.decode", "device_ms")
