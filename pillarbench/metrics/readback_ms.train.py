"""The host ms of the losses' read-back on logging steps, over all steps: the
program's span ``fit.readback`` in ``train.loop.fit``; 0 where no logging
step fell in the stretch."""

from pillarbench.program_spans import per_unit


def read(run):
    return per_unit(run, "fit.step", "fit.readback", absent=0.0)
