"""Device time by kind of operation, from the traced window."""

from typing import Callable, Optional

# the port's hand-written serving kernels (frizbee_tpu_torch/csrc), by
# the name the profiler gives their launches
HAND_KERNELS = ("colstream_fuzzy_kernel", "colstream_fuzzy_pairs_kernel",
                "colstream_literal_kernel", "match_units_kernel",
                "row_gather_kernel")


def is_hand_kernel(name: str) -> bool:
    return any(k in name for k in HAND_KERNELS)


def device_ms_where(run, keep: Callable[[str], bool]) -> Optional[float]:
    """Device ms a served batch in the operations whose name ``keep``
    accepts, over the traced window, summed over the cards."""
    if run.trace is None or not run.served:
        return None
    w0, w1 = run.trace.window()
    total = sum(min(b, w1) - max(a, w0) for name, a, b in run.trace.device
                if b > w0 and a < w1 and keep(name))
    return total / 1e6 / len(run.served)


def device_ms_per_batch(run, hand: bool):
    """Device ms a served batch in the hand kernels (``hand``) or in all
    other device work, over the traced window."""
    return device_ms_where(run, lambda name: is_hand_kernel(name) == hand)
