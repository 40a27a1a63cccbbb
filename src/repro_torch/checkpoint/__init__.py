from repro_torch.checkpoint.ckpt import (
    load_checkpoint,
    load_extra,
    load_flat,
    manifest_path,
    params_from_numpy,
    save_checkpoint,
    stack_clients,
    unflatten,
    unstack_clients,
)

__all__ = [
    "load_checkpoint",
    "load_extra",
    "load_flat",
    "manifest_path",
    "params_from_numpy",
    "save_checkpoint",
    "stack_clients",
    "unflatten",
    "unstack_clients",
]
