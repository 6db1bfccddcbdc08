"""Kernel launches (copies and fills not counted) in the traced window
over the steps run in it: the eager dispatch of autograd and the
per-leaf AdamW.  Moves ``train_tok_s``."""


def read(t):
    if t.info.get("kind") != "train" or not t.info["steps"]:
        return None
    return len(t.kernels()) / t.info["steps"]
