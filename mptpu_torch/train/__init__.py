"""Training harness of the port (counterpart of ``mptpu.train``; only the
ported names)."""

from .optim import make_train_step, optimizer
from .overfit import overfit_model

__all__ = ["make_train_step", "optimizer", "overfit_model"]
