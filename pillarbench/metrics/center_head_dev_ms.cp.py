"""The device ms of a batch's centre head, pipelined and unsynchronised:
the program's span ``detector.center_head``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.center_head", "device_ms")
