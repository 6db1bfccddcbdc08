"""The share of the traced window in which no operation ran on the
device: 1 - (the union of the device's operations) / (the window).
Moves ``train_tok_s``."""


def read(t):
    if t.info.get("kind") != "train":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
