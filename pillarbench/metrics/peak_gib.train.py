"""The card's peak allocated memory over the run, GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
