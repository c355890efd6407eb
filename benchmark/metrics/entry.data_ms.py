"""``entry.data_ms``: host ms a step in the benchmark's ``entry.batch`` span
(the iterator's next batch and its move to the card), the mean over the
traced window's iterations outside the profiled sub-window."""


def read(run):
    return sum(run.data_ms) / len(run.data_ms) if run.data_ms else None
