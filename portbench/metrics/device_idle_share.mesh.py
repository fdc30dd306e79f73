"""Device on a mesh: the share of the traced window in which no operation
ran, 1 - busy / window for each of the cell's cards, averaged over them;
a card that ran nothing in the window reads 1."""


def read(run):
    if run.trace is None:
        return None
    chips = run.cell.chips
    window = run.trace.window_s()
    return sum(1.0 - busy / window
               for busy in run.trace.card_busy_s(chips)) / chips
