"""The card's idle share of the profiled training stretch, %."""

from pillarbench.readers import idle_share


def read(run):
    return idle_share(run)
