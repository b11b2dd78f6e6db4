from repro_torch.train.state import TrainState  # noqa: F401
from repro_torch.train.trainer import Trainer, quick_train  # noqa: F401
