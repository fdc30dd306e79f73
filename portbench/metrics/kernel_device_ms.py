"""Kernels: device ms a batch in the port's hand-written kernels (their
names in metrics/_device.py), from the traced window."""

from portbench.metrics._device import device_ms_per_batch


def read(run):
    ms = device_ms_per_batch(run, hand=True)
    return ms if ms else None
