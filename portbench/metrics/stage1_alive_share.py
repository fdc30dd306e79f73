"""Host serving: the share of (group, query) pairs the finalize-cap
chooser found alive after stage 1, from the program's
``matcher.SERVING_COUNTS`` over every batch the process served (the
warm-up's pass over the mix and the window); every pair where no stage 1
narrows the groups. Fixed by the mix while stage 1 stays exact, so a move
flags a route change. None where the program keeps no such counts."""

from portbench.program_spans import serving_counts


def read(run):
    counts = serving_counts()
    if not counts or not counts["cap_pairs"]:
        return None
    return counts["alive_pairs"] / counts["cap_pairs"]
