"""Front end K1-K3 (``Detector.canvas``) of a batch, ms: synchronised
spans."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "frontend")
