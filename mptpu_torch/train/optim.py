"""The optimiser factory and the guarded train step (counterpart of
``optimizer`` and ``make_train_step`` in ``mptpu/train/optim.py``).

``torch.optim.Adam`` and ``optax.adam`` compute the same update: both add
``eps`` outside the square root of the bias-corrected second moment
(``tests/test_torch_splat.py`` holds them against each other).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def optimizer(params: Iterable[torch.Tensor], lr: float = 1e-4, b1: float = 0.0,
              b2: float = 0.9) -> torch.optim.Adam:
    """Adam over ``params``; the defaults are the reference's, lr 1e-4 and
    betas (0, 0.9)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2))


def make_train_step(loss_fn: Callable[..., torch.Tensor], opt: torch.optim.Optimizer):
    """``step(*args) -> loss``: the loss and its gradients, then the update,
    unless the loss is not finite: then neither the parameters nor the
    optimiser's state change (the reference's NaN/Inf guard). The check
    reads the loss on the host, one synchronisation a step."""

    def step(*args) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(*args)
        loss.backward()
        if bool(torch.isfinite(loss)):
            opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step
