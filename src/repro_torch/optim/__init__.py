from repro_torch.optim.optimizers import (Leaf, adafactor_init, adafactor_update, adamw_init,
                                         adamw_update, global_norm, make_optimizer)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["Leaf", "adafactor_init", "adafactor_update", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "make_optimizer"]
