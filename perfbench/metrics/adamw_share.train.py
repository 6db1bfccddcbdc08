"""Device time of the optimizer over the traced window: the program's
span ``train.adamw`` (the clipping norm and every leaf's update).  Moves
``train_tok_s``."""
import program_spans
from yardstick import spans


def read(t):
    if t.info.get("kind") != "train":
        return None
    return spans.window_share(t, program_spans.records(t),
                              ("train.adamw",))
