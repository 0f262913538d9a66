"""The GAN training alternation (counterpart of ``mptpu/train/gan.py``)."""

from __future__ import annotations

from itertools import cycle
from typing import Callable, Dict, List, Sequence, Union

import torch

from ..losses.gan import least_squares_disc_loss, least_squares_generator_loss

Params = Union[Dict[str, torch.Tensor], Sequence[torch.Tensor]]


def gan_cycle():
    """The endless alternation 'gen', 'disc', 'gen', ..."""
    return cycle(["gen", "disc"])


def _leaves(params: Params) -> List[torch.Tensor]:
    return list(params.values()) if isinstance(params, dict) else list(params)


def _rebuild(params: Params, leaves: List[torch.Tensor]) -> Params:
    return dict(zip(params, leaves)) if isinstance(params, dict) else leaves


def _step(params: Params, opt_state, opt, loss_of: Callable[[Params], torch.Tensor]):
    """One optax-form step of ``params`` alone: (new params, new state,
    loss). The inputs are not changed."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    loss = loss_of(_rebuild(params, leaves))
    # a parameter the loss does not reach gets a zero gradient, as from jax.grad
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    updates, opt_state = opt.update(grads, opt_state)
    new = [(p + u).detach() for p, u in zip(leaves, updates)]
    return _rebuild(params, new), opt_state, loss.detach()


def make_gan_steps(gen_apply: Callable, disc_apply: Callable, gen_opt, disc_opt):
    """``(train_gen, train_disc)``, each a functional step that
    differentiates its own player's parameters only.

    ``gen_apply(gen_params, batch, key) -> fake`` and ``disc_apply(
    disc_params, x) -> judgements`` take parameters as a dict of tensors
    (e.g. for ``torch.func.functional_call``) or a list; ``gen_opt`` and
    ``disc_opt`` are optax-form optimisers (``train.optim.Adam``:
    ``update(grads, state) -> (updates, state)``). ``key`` is whatever
    ``gen_apply`` draws its noise from (a generator or the draw itself).

    ``train_gen(gen_params, gen_opt_state, disc_params, batch, key)`` and
    ``train_disc(disc_params, disc_opt_state, gen_params, batch, key)``
    return (new parameters, new optimiser state, loss)."""

    def train_gen(gen_params, gen_opt_state, disc_params, batch, key):
        disc = _rebuild(disc_params, [p.detach() for p in _leaves(disc_params)])
        return _step(gen_params, gen_opt_state, gen_opt, lambda gp: least_squares_generator_loss(
            disc_apply(disc, gen_apply(gp, batch, key))))

    def train_disc(disc_params, disc_opt_state, gen_params, batch, key):
        gen = _rebuild(gen_params, [p.detach() for p in _leaves(gen_params)])
        with torch.no_grad():
            fake = gen_apply(gen, batch, key)
        return _step(disc_params, disc_opt_state, disc_opt, lambda dp: least_squares_disc_loss(
            disc_apply(dp, batch), disc_apply(dp, fake)))

    return train_gen, train_disc
