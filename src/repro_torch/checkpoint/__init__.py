from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 restore, save)

__all__ = ["Checkpointer", "save", "restore", "latest_step"]
