"""The whole serving step, % of the stated dtype's peak: model FLOPs of
the sweeps served in the profiled stretch over its seconds."""

from pillarbench.readers import mfu


def read(run):
    return mfu(run, training=False)
