"""Piecewise ops with ``jax.grad``'s gradient at their kinks.

Autograd and JAX agree away from a kink and differ on it:

- ``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``, gradient 1 at
  0, where ``F.leaky_relu`` gives ``slope``;
- ``jnp.clip`` is a maximum, then a minimum, and ``jnp.maximum`` and
  ``jnp.minimum`` split a tie's gradient in half: an input exactly on a
  bound passes half its gradient, where ``torch.clamp`` passes all of it.
  ``torch.maximum`` and ``torch.minimum`` split ties as JAX does;
- ``jnp.abs`` of a real input passes the whole gradient at 0 (and -0.0),
  ``select(x >= 0, g, -g)``, where ``torch.abs`` passes none. Of a
  complex input both pass none, so a complex ``abs`` keeps ``torch.abs``.

Exact zeros are common where the port trains (a dead event renders 0, a
relu selection sits at 0), so every op that ``mptpu`` differentiates
through goes through these. A clamp inside ``straight_through(clamp(h),
h)`` is not differentiated and needs none of this.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _LeakyRelu(torch.autograd.Function):
    """``F.leaky_relu``'s values (one kernel) with JAX's gradient."""

    @staticmethod
    def forward(ctx, x, negative_slope):
        ctx.save_for_backward(x)
        ctx.negative_slope = negative_slope
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, grad * ctx.negative_slope), None


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``x`` where ``x >= 0``, else ``slope * x``
    (``F.leaky_relu``'s values, its gradient 1 at 0)."""
    return _LeakyRelu.apply(x, negative_slope)


class _Abs(torch.autograd.Function):
    """``torch.abs``'s values (one kernel) with JAX's gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, -grad)


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 (jnp.abs's name)
    """``jnp.abs`` of a real tensor: ``torch.abs``'s values, gradient
    ``g`` where ``x >= 0`` (0.0 and -0.0 included), else ``-g``."""
    if x.is_complex():
        raise TypeError("kinks.abs takes a real tensor; a complex one keeps torch.abs")
    return _Abs.apply(x)


def clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: a maximum with ``lo``, then a minimum with
    ``hi`` (either may be None). The bounds are 0-d CPU tensors, which a
    CUDA op reads as scalars."""
    if lo is not None:
        x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype))
    return x
