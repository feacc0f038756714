"""Optimizer: AdamW with the reference's cosine schedule and global-norm
clipping, and int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
