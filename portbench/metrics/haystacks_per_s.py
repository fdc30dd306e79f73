"""Serving throughput: queries answered x corpus rows, over the whole
window (host clock: from the first dispatch to the last answer)."""


def read(run):
    if not run.served or run.window_s <= 0:
        return None
    return run.queries_served * run.n_rows / run.window_s
