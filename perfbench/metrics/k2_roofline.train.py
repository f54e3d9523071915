"""k2_roofline.train (%): kernel K2's least time at each traced launch's
shape over its traced time, in the training cells.  Moves
train_windows_per_s."""

from harness import readers


def read(obs):
    return readers.k2_roofline_pct(obs)
