"""Batch ops: device ms a batch in CUDA work other than the port's hand
kernels (stage 1, combine, finalize sort, copies), from the traced
window."""

from portbench.metrics._device import device_ms_per_batch


def read(run):
    ms = device_ms_per_batch(run, hand=False)
    return ms if ms else None
