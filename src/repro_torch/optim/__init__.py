from repro_torch.optim.optimizers import adamw_init, adamw_update, global_norm

__all__ = ["adamw_init", "adamw_update", "global_norm"]
