"""The host ms a batch's upload and dequant hold the host: the program's span
``detector.upload`` (a pageable copy returns once the card has taken it)."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "detector.predict", "detector.upload")
