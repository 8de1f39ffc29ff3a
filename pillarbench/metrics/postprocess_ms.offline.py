"""Postprocess with K4 (``Detector.postprocess``) of a batch, ms:
synchronised spans."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "postprocess")
