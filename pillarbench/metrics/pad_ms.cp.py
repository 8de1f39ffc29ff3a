"""Host pad and crop (``Detector.pad_points``) of a batch of 10-sweep
clouds, ms: the traced run's host-clock spans ``pad``."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "pad")
