from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          clip_by_global_norm, lamb,
                                          make_optimizer, sgd)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
