"""The device ms of a batch's upload and dequant, pipelined and unsynchronised:
the events of the program's span ``detector.upload``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.upload", "device_ms")
