from repro_torch.optim.optimizers import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    make_optimizer,
)
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "make_optimizer",
    "warmup_cosine",
]
