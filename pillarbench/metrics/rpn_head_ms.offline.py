"""RPN and head (``Detector.wire``) of a batch, ms: synchronised spans."""

from pillarbench.readers import span_mean


def read(run):
    return span_mean(run, "rpn_head")
