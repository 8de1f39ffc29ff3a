"""The whole training step, % of the stated dtype's peak: 3x the forward's
model FLOPs of the samples trained in the profiled stretch over its
seconds."""

from pillarbench.readers import mfu


def read(run):
    return mfu(run, training=True)
