"""Whole training step's share of the card's bf16 peak: the benchmark's
model operations of the traced window's steps (6 per product weight and
token, the causal attention's forward and backward; recompute not
counted) over the traced window's length times the peak.  Moves
``train_tok_s``."""


def read(t):
    if t.info.get("kind") != "train" or not t.info["steps"] or t.peak is None:
        return None
    return 100.0 * t.info["model_flops"] / (t.window_s * t.peak["bf16_flops"])
