"""The device ms of a batch's front end (the sort, K1, K2's two-layer
instance, K3; ``Detector.canvas``), pipelined and unsynchronised: the
program's span ``detector.frontend``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.frontend", "device_ms")
