"""Training harness of the port (counterpart of ``mptpu.train``: every name
of its ``__all__``, and a few more)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .gan import gan_cycle, make_gan_steps
from .guard import StormGuard
from .optim import (Adam, AdamState, adam_init, adam_update, apply_gated, global_norm,
                    make_train_step, optimizer, trust_ratio_clip)
from .overfit import overfit_model
from .runner import BaseExperimentRunner

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint", "StormGuard", "Adam",
           "AdamState", "adam_init", "adam_update", "apply_gated", "global_norm",
           "make_train_step", "optimizer", "trust_ratio_clip", "overfit_model",
           "BaseExperimentRunner", "gan_cycle", "make_gan_steps"]
