from repro_torch.sharding.rules import (  # noqa: F401
    batch_pspec,
    cache_pspecs,
    gather_block,
    local_block,
    param_pspecs,
    sanitize_pspec,
    tree_shardings,
)
