"""Heatmap cells over the score threshold and inside the limit range, a
cloud, summed over the six tasks before the top-1,000 cut: the program
counter ``center.candidates`` (the cut lets 6,000 through)."""

from pillarbench.readers_center import counter_per_cloud


def read(run):
    return counter_per_cloud(run, "center.candidates")
