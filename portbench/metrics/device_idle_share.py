"""Device: the share of the traced window in which no operation ran on
the card, 1 - busy / window."""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s()
