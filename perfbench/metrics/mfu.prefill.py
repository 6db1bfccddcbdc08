"""Whole prefill's share of the card's bf16 peak: the benchmark's model
operations of the prompts served in the traced window (2 per layer
product weight and token, the causal attention's forward, the head at the
last position) over the traced window's length times the peak.  Moves
``prefill_tok_s``."""


def read(t):
    if t.info.get("kind") != "prefill" or not t.info["requests"] or \
            t.peak is None:
        return None
    return 100.0 * t.info["model_flops"] / (t.window_s * t.peak["bf16_flops"])
