"""device_idle_pct.serve (%): the share of the traced region of a backlog
replay that no device operation covers.  Moves serve_windows_per_s."""

from harness import readers


def read(obs):
    return readers.device_idle_pct(obs)
