"""Training harness of the port (counterpart of ``mptpu.train``; only the
ported names)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .guard import StormGuard
from .optim import (Adam, AdamState, adam_init, adam_update, apply_gated, global_norm,
                    make_train_step, optimizer, trust_ratio_clip)
from .overfit import overfit_model

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint", "StormGuard", "Adam",
           "AdamState", "adam_init", "adam_update", "apply_gated", "global_norm",
           "make_train_step", "optimizer", "trust_ratio_clip", "overfit_model"]
