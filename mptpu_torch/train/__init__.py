"""Training harness of the port (counterpart of ``mptpu.train``; only the
ported names)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .optim import make_train_step, optimizer
from .overfit import overfit_model

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint", "make_train_step",
           "optimizer", "overfit_model"]
