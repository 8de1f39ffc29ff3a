"""The host ms a training step waits for its batch: the program's span
``fit.data`` around ``next(batches)`` in ``train.loop.fit``."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "fit.step", "fit.data")
