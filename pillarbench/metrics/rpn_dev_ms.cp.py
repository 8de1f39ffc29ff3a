"""The device ms of a batch's RPN, pipelined and unsynchronised: the
program's span ``detector.rpn``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.rpn", "device_ms")
