"""Kernels: the least time of the served batches' matching work
(portbench/roofline.py, counted from the corpus and the queries through
the reference's own prefilter and windows) over all the card's busy time
in the traced window, in %. Dividing by all busy time, not the hand
kernels' alone, keeps it under 100% wherever the work runs."""

from portbench import roofline


def read(run):
    if run.trace is None or not run.served:
        return None
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * roofline.served_least_s(run) / busy
