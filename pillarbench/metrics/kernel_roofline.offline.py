"""The serving kernels K1-K4 against their roofline, %: their bounds at
the pool's mean counts over their device time in the profiled stretch."""

from pillarbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, ("K1", "K2", "K3", "K4"))
