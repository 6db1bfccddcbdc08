"""The sm90 flash forward's share of its roofline in the prefill: each launch's
least time (the larger of its operations over the bf16 peak and its bytes
over the memory bandwidth, from the call's shapes) over the measured time
of every ``flash_fwd_sm90_kernel`` launch in the traced window (one
launch a call).  Moves ``prefill_tok_s``."""
from yardstick.peaks import least_seconds


def read(t):
    if t.info.get("kind") != "prefill" or t.peak is None:
        return None
    ks = t.kernels(lambda n: "flash_fwd_sm90_kernel" in n)
    if not ks:
        return None
    ops, byts = t.info["attn_fwd"]
    return 100.0 * len(ks) * least_seconds(ops, byts, t.peak) / t.seconds(ks)
