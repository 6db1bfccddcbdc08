"""Device time of the prefill's cache fill over the traced window: the
program's span ``lm.prefill.kv_state`` (each attention layer's norm, q/k/v
products, qk-norm and RoPE run again to lay k and v into the cache).
Moves ``prefill_tok_s``."""
import program_spans
from yardstick import spans


def read(t):
    if t.info.get("kind") != "prefill":
        return None
    return spans.window_share(t, program_spans.records(t),
                              ("lm.prefill.kv_state",))
