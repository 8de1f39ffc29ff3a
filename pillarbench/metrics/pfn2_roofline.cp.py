"""K2's two-layer instance (``fpfn2_kernel``) against its roofline, %:
its bound at the pool's mean counts over its device time in the profiled
stretch."""

from pillarbench.readers_center import kernel_roofline


def read(run):
    return kernel_roofline(run, ("K2b",))
