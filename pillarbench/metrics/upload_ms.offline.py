"""Upload and dequantize (``Detector.upload``, ``dequant``) of a batch, ms:
synchronised spans."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "upload")
