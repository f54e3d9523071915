"""device_idle_pct.rate (%): the share of the traced region of an
open-loop fleet that no device operation covers.  Moves event_p95_ms."""

from harness import readers


def read(obs):
    return readers.device_idle_pct(obs)
