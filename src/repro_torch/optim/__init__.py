from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, moment_dtype)
from repro_torch.optim.schedules import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "moment_dtype", "cosine_schedule"]
