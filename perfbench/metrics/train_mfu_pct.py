"""train_mfu_pct (%): the whole training step's model FLOPs, by the reference's
closed form, over the traced fit's time, as a share of the card's peak bf16
rate.  Moves train_windows_per_s."""

from harness import readers


def read(obs):
    return readers.mfu_pct(obs, train=True)
