"""Training front end (sort, K1, the fused PFN on batch statistics) a
step, ms: the step's own synchronised split."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "frontend")
