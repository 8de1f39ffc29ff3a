"""Tensor ops of the port: the front end, its kernels and the postprocess."""
