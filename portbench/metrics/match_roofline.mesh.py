"""Kernels on a mesh: the least time of the served batches' matching work
on one H100 (portbench/roofline.py, the same counts and peaks as
match_roofline) over the busy seconds of the cell's cards summed, in %.
The work is the same whichever cards run it, so the share stays under
100% on any number of cards; it falls where the cards do work again or
wait for each other while busy."""

from portbench import roofline


def read(run):
    if run.trace is None or not run.served:
        return None
    busy = sum(run.trace.card_busy_s(run.cell.chips))
    if busy <= 0:
        return None
    return 100.0 * roofline.served_least_s(run) / busy
