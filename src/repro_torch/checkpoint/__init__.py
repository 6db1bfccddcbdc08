from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               load_checkpoint,
                                               reshard_state,
                                               save_checkpoint, tree_paths)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint",
           "reshard_state", "tree_paths"]
