"""Backward a step, ms: the step's split."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "backward")
