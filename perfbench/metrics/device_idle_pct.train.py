"""device_idle_pct.train (%): the share of the traced fit that no device
operation covers.  Moves train_windows_per_s."""

from harness import readers


def read(obs):
    return readers.device_idle_pct(obs)
