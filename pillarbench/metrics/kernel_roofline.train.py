"""The training kernels K1, K3 and K5 against their roofline, %."""

from pillarbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, ("K1", "K3", "K5"),
                           run.traffic["max_gt_per_class"])
