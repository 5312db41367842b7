from repro_torch.optim.adamw import adamw_init, adamw_update, lr_at

__all__ = ["adamw_init", "adamw_update", "lr_at"]
