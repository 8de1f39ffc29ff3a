"""The card's idle ms between two batches as the program sees it: the gap
of the program's unit span ``detector.predict``."""

from pillarbench.program_spans import gap_ms


def read(run):
    return gap_ms(run, "detector.predict")
