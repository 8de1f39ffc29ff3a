"""The device ms of a batch's NMS (K4 and the fixpoint) and packing,
pipelined and unsynchronised: the program's span ``detector.nms``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.nms", "device_ms")
