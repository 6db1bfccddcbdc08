"""The LM serving path of the port (``repro/models``, attention family)."""
from repro_torch.models.model import (Batch, count_params, decode_step,
                                      forward, init_cache, init_params,
                                      last_logits, param_defs)

__all__ = ["Batch", "count_params", "decode_step", "forward", "init_cache",
           "init_params", "last_logits", "param_defs"]
