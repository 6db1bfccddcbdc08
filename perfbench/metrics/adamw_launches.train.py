"""Kernel launches a step inside the optimizer: the runtime's launch
calls (``cudaLaunchKernel``, ``cuLaunchKernel*``) that start inside the
host ranges of the program's span ``train.adamw``, over the window's
steps.  Moves ``train_tok_s``."""
from yardstick import spans


def read(t):
    if t.info.get("kind") != "train" or not t.info["steps"]:
        return None
    adamw = spans.ranges(t, "train.adamw")
    if not adamw:
        return None
    return spans.launches_in(t, adamw) / t.info["steps"]
