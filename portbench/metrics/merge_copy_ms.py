"""Collectives: device ms a served batch in copies from one card to
another, the single controller's gather of each shard's top-k rows and
match counts onto the first card, from the traced window, summed over
the cards. The profiler names such a copy "Memcpy PtoP (Device ->
Device)"; copies between the host and a card, and inside one card, are
not counted."""

from portbench.metrics._device import device_ms_where

PEER_COPY = "Memcpy PtoP"


def read(run):
    ms = device_ms_where(run, lambda name: name.startswith(PEER_COPY))
    return ms if ms else None
