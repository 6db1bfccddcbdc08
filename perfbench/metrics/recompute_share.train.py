"""Device time of the activation recompute over the traced window: the
program's span ``lm.group.recompute`` (a checkpointed layer group's
forward run again in the backward pass).  Moves ``train_tok_s``."""
import program_spans
from yardstick import spans


def read(t):
    if t.info.get("kind") != "train":
        return None
    return spans.window_share(t, program_spans.records(t),
                              ("lm.group.recompute",))
