"""The device ms of a batch's RPN and head (``Detector.wire``), pipelined and
unsynchronised: the program's span ``detector.rpn_head``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.rpn_head", "device_ms")
