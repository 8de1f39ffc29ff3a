"""The device ms of a batch's postprocess and packing, pipelined and
unsynchronised: the program's span ``detector.postprocess``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.postprocess", "device_ms")
