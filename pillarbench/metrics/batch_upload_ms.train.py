"""The host ms of a step's batch upload: the program's span ``fit.upload``
around ``batch_to_device`` in ``train.loop.fit``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "fit.step", "fit.upload")
