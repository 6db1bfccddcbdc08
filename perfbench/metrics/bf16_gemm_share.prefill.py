"""Device time of bf16 GEMM kernels (cuBLAS's by name) over all device time in the traced window
(the model blocks' products).  Moves ``prefill_tok_s``."""
from yardstick.kernels import bf16_gemm


def read(t):
    if t.info.get("kind") != "prefill":
        return None
    total = t.seconds(t.device)
    return 100.0 * t.seconds(t.kernels(bf16_gemm)) / total if total else None
