"""Device time of the loss head over the traced window: the program's
spans ``lm.head.fwd`` (each 512-position chunk's fp32 logits, logsumexp
and label logit) and ``lm.head.bwd`` (from the loss's gradient to the
gradient at the head's input), summed.  Moves ``train_tok_s``."""
import program_spans
from yardstick import spans


def read(t):
    if t.info.get("kind") != "train":
        return None
    return spans.window_share(t, program_spans.records(t),
                              ("lm.head.fwd", "lm.head.bwd"))
