"""Device time of fp32 GEMM kernels (cuBLAS's by name) over all device time in the traced window
(the loss head: the step's only fp32 products).  Moves ``train_tok_s``."""
from yardstick.kernels import fp32_gemm


def read(t):
    if t.info.get("kind") != "train":
        return None
    total = t.seconds(t.device)
    return 100.0 * t.seconds(t.kernels(fp32_gemm)) / total if total else None
