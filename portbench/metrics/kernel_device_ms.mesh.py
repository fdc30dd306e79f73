"""Kernels on a mesh: device ms a served batch in the port's hand-written
kernels (their names in metrics/_device.py), summed over the cell's
cards, from the traced window: kernel_device_ms's reading, named apart
because four cards' sum is no one card's time."""

from portbench.metrics.kernel_device_ms import read  # noqa: F401
