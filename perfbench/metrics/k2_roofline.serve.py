"""k2_roofline.serve (%): kernel K2's least time at each traced launch's
shape over its traced time, in the fleet's dispatches.  Moves
serve_windows_per_s."""

from harness import readers


def read(obs):
    return readers.k2_roofline_pct(obs)
