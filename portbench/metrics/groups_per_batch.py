"""Host serving: device passes (shape groups) a batch, from the program's
``matcher.SERVING_COUNTS`` over every batch the process served (the
warm-up's pass over the mix and the window; every batch of a mix holds
the same shape groups). None where the program keeps no such counts."""

from portbench.program_spans import serving_counts


def read(run):
    counts = serving_counts()
    if not counts or not counts["batches"]:
        return None
    return counts["groups"] / counts["batches"]
