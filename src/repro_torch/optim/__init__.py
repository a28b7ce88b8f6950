from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule"]
