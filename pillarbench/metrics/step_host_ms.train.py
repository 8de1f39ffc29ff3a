"""The host ms of a step's call: the program's span ``fit.step`` less its
``fit.upload`` and ``fit.readback``. Near the step's own time, something in
the step synchronises."""

from pillarbench.program_spans import step_host_ms


def read(run):
    return step_host_ms(run, "fit.step", ("fit.upload", "fit.readback"))
