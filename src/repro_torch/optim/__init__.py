from repro_torch.optim.optim import (  # noqa: F401
    Optimizer,
    adamw_init,
    adamw_update,
    make_optimizer,
    sgd_init,
    sgd_update,
)
