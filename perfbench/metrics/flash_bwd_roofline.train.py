"""The sm90 flash backward's share of its roofline in training: the least
time of the traced window's backward calls (one a layer a step; the
larger of their operations over the bf16 peak and their bytes over the
memory bandwidth) over the measured time of its prep, dQ, dK/dV and
reduce kernels (``flash_bwd_*_kernel``).  Moves ``train_tok_s``."""
from yardstick.peaks import least_seconds


def read(t):
    if t.info.get("kind") != "train" or t.peak is None:
        return None
    ks = t.kernels(lambda n: "flash_bwd_" in n and "_kernel" in n)
    if not ks:
        return None
    ops, byts = t.info["attn_bwd"]
    calls = t.info["attn_bwd_calls"]
    return 100.0 * calls * least_seconds(ops, byts, t.peak) / t.seconds(ks)
