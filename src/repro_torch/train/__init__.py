from repro_torch.train.state import TrainState  # noqa: F401
from repro_torch.train.trainer import Trainer  # noqa: F401
