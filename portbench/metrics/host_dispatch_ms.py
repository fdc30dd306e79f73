"""Host serving: mean host ms a batch spent inside
match_topk_batch_async (query compile, grouping, the finalize-cap
chooser, enqueue), from the benchmark's spans in the traced run."""


def read(run):
    if run.trace is None:
        return None
    d = [b - a for name, a, b in run.trace.spans if name == "dispatch"]
    if not d:
        return None
    return sum(d) / len(d) / 1e6
