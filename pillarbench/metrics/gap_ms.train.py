"""The card's idle ms between two training steps as the program sees it: the
gap of the program's unit span ``fit.step``."""

from pillarbench.program_spans import gap_ms


def read(run):
    return gap_ms(run, "fit.step")
