"""Host pad and crop (``Detector.pad_points``) of a batch, ms: the traced
run's host-clock spans."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "pad")
