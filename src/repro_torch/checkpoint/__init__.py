from repro_torch.checkpoint.io import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "latest_step"]
