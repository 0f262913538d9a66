"""The single-segment overfit loop (counterpart of
``mptpu/train/overfit.py``)."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from .optim import make_train_step, optimizer


def overfit_model(params: Iterable[torch.Tensor], loss_fn: Callable, target: torch.Tensor,
                  n_iterations: int = 1000, lr: float = 1e-3,
                  generator: Optional[torch.Generator] = None,
                  after_iteration: Optional[Callable] = None, log_every: int = 50):
    """Fit ``params`` (tensors that require grad, updated in place) to one
    target with Adam (betas 0.9, 0.999). ``loss_fn(target, generator)``
    returns a scalar; ``generator`` (default: the default generator of the
    target's device) stands for ``mptpu``'s per-step key. Returns (params,
    the loss at every ``log_every``-th step); ``after_iteration(i, params,
    loss)`` runs after each step."""
    params = list(params)
    step = make_train_step(loss_fn, optimizer(params, lr=lr, b1=0.9, b2=0.999))
    losses = []
    for i in range(n_iterations):
        loss = step(target, generator)
        if i % log_every == 0:
            losses.append(float(loss))
        if after_iteration is not None:
            after_iteration(i, params, loss)
    return params, losses
