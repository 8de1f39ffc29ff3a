"""The serving kernels K1, K2's two-layer instance, K3 and K4 against
their roofline at this cell's counts, %."""

from pillarbench.readers_center import kernel_roofline


def read(run):
    return kernel_roofline(run, ("K1", "K2b", "K3", "K4"))
