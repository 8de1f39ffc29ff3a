"""The whole serving step, % of the f32 peak: the CenterPoint model FLOPs
of the clouds served in the profiled stretch over its seconds."""

from pillarbench.readers_center import mfu


def read(run):
    return mfu(run)
