from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, cosine_lr, global_norm)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_lr", "global_norm"]
