from repro_torch.optim.adamw import adamw_init, adamw_update, lr_at, state_bytes
from repro_torch.optim.compress import init_compression_state

__all__ = ["adamw_init", "adamw_update", "init_compression_state", "lr_at", "state_bytes"]
