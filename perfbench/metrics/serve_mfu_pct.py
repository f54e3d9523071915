"""serve_mfu_pct (%): the forward's model FLOPs, by the reference's closed
form, for the windows scored in the traced region, over its time, as a
share of the card's peak bf16 rate.  Moves serve_windows_per_s."""

from harness import readers


def read(obs):
    return readers.mfu_pct(obs, train=False)
