"""What every run pays before it serves: from the process's start to the
window's first batch (loading, corpus generation and packing, traffic,
warm-up; in a checkout's first run, the kernels' builds)."""


def read(run):
    return run.setup_s or None
