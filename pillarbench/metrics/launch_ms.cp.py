"""The host ms of a batch's launch: the program's span
``detector.predict`` (``Detector.predict_packed_batch``, upload included)."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.predict")
