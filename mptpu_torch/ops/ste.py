"""Straight-through estimators: a hard forward with a soft backward
(counterpart of ``mptpu/ops/ste.py``).

Every estimator is ``backward + (forward - backward).detach()``: the value
is ``forward``'s, the gradient ``backward``'s. ``mptpu`` writes the same
with ``lax.stop_gradient`` and has no custom backward rule, so none is
needed here either.
"""

from __future__ import annotations

import torch

from .kinks import leaky_relu
from .norms import max_norm


def straight_through(forward: torch.Tensor, backward: torch.Tensor) -> torch.Tensor:
    """Value of ``forward``, gradient of ``backward``."""
    return backward + (forward - backward).detach()


def leaky_relu_ste(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """Forward exactly ``relu(x)``; backward the leaky-relu gradient, so
    that an amplitude gate whose pre-activations all went negative still
    gets a gradient (1 at 0, as ``jax.nn.leaky_relu``'s)."""
    return straight_through(torch.relu(x), leaky_relu(x, negative_slope))


def _one_hot_argmax(x: torch.Tensor, axis: int, values: torch.Tensor) -> torch.Tensor:
    """Zeros like ``x`` with ``values`` at the first argmax along ``axis``."""
    idx = torch.argmax(x, dim=axis, keepdim=True)
    return torch.zeros_like(x).scatter(axis, idx, values)


def sparse_softmax(x: torch.Tensor, normalize: bool = False, axis: int = -1) -> torch.Tensor:
    """Softmax backward; forward one-hot at the largest probability, holding
    that probability, or 1 when ``normalize``."""
    soft = torch.softmax(x, dim=axis)
    values = torch.amax(soft, dim=axis, keepdim=True)
    if normalize:
        # kept literal: in float32 it is 1 where values is small, and 0 where
        # values is so large that 1 - values rounds to -values, as in mptpu
        values = values + (1 - values)
    return straight_through(_one_hot_argmax(soft, axis, values), soft)


def soft_dirac(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax backward, exact one-hot forward."""
    soft = torch.softmax(x, dim=axis)
    values = torch.ones_like(torch.amax(soft, dim=axis, keepdim=True))
    return straight_through(_one_hot_argmax(soft, axis, values), soft)


def soft_clamp(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] forward, identity backward."""
    return straight_through(torch.clamp(x, 0.0, 1.0), x)


def step_func(x: torch.Tensor) -> torch.Tensor:
    """Sign forward, identity backward."""
    return straight_through(torch.sign(x), x)


def _hard_softmax_from_uniform(
    x: torch.Tensor, u: torch.Tensor, axis: int = -1, invert: bool = False, tau: float = 1.0
) -> torch.Tensor:
    """``hard_softmax`` with its uniform draws ``u`` (shaped like ``x``, in
    [1e-20, 1)) given, so that ``mptpu``'s draws can be fed in."""
    if invert:
        x = torch.exp(max_norm(x))
    gumbels = -torch.log(-torch.log(u))
    soft = torch.softmax((x + gumbels) / tau, dim=axis)
    values = torch.ones_like(torch.amax(soft, dim=axis, keepdim=True))
    return straight_through(_one_hot_argmax(soft, axis, values), soft)


def hard_softmax(
    x: torch.Tensor,
    axis: int = -1,
    invert: bool = False,
    tau: float = 1.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Hard Gumbel-softmax sample: one-hot forward, the softmax of the
    perturbed logits backward. The noise is drawn from ``generator`` (one
    on ``x``'s device; the default generator of that device when None), in
    place of ``mptpu``'s explicit PRNG key."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    u = torch.clamp_min(u, 1e-20)   # [1e-20, 1), as mptpu's minval / maxval
    return _hard_softmax_from_uniform(x, u, axis=axis, invert=invert, tau=tau)
