"""Checkpoints in the reference's npz format (counterpart of
``repro/checkpoint``)."""
from repro_torch.checkpoint.ckpt import (latest_step,  # noqa: F401
                                         restore_checkpoint, save_checkpoint)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
