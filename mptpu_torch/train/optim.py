"""The optimiser factory, the guarded train step, optax's Adam in
functional form and the trust-ratio clip (counterpart of
``mptpu/train/optim.py``).

``torch.optim.Adam`` and ``optax.adam`` compute the same update: both add
``eps`` outside the square root of the bias-corrected second moment
(``tests/test_torch_splat.py`` holds them against each other). The SIAM
trainers need the update itself (to clip it per parameter) and a state
they can gate on the device, so they use ``adam_init`` and
``adam_update``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Sequence

import torch

from ..device import grid_dtype
from ..ops.kinks import clip


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


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` over a list of tensors: the int32 step
    count and the first and second moments, one per parameter."""

    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    """Zero moments and a zero count on the parameters' device."""
    params = list(params)
    count = torch.zeros((), dtype=torch.int32, device=params[0].device)
    return AdamState(count, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def adam_update(grads: Sequence[torch.Tensor], state: AdamState, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """``optax.adam(lr, b1, b2, eps).update``: (updates, new state), the
    updates already scaled by ``-lr``. As optax: the moments ``(1 - b) * g
    + b * m``, the count raised before the bias correction ``1 - b **
    count``, and ``eps`` added outside the square root. Nothing is read on
    the host, so that a caller can gate the new state on the device.
    ``torch.optim.Adam`` computes the same update but keeps its state
    inside, where a gate cannot reach it."""
    grads = list(grads)
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(state.mu, b1))
    sq = torch._foreach_mul(grads, grads)
    nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2), torch._foreach_mul(state.nu, b2))
    count = state.count + 1
    dtype = grads[0].dtype
    wide = grid_dtype(grads[0])   # the bias corrections in float64 for float64 gradients
    steps = count.to(wide)
    bc1 = (1 - torch.pow(torch.tensor(b1, dtype=wide, device=steps.device), steps)).to(dtype)
    bc2 = (1 - torch.pow(torch.tensor(b2, dtype=wide, device=steps.device), steps)).to(dtype)
    mu_hat = torch._foreach_div(mu, bc1)
    nu_hat = torch._foreach_div(nu, bc2)
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
    return updates, AdamState(count, mu, nu)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the l2 norm of all the tensors together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def trust_ratio_clip(updates: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                     ratio: float, floor: float = 1e-3) -> List[torch.Tensor]:
    """``mptpu.train.trust_ratio_clip(ratio, floor)``'s update: each
    parameter's update scaled so that its norm is at most ``ratio *
    max(||p||, floor)``, after Adam and before the update is applied. The
    floor lets a parameter that starts at zero (every bias) take steps; its
    cap then grows with it."""
    out = []
    for u, p in zip(updates, params):
        un = torch.linalg.vector_norm(u)
        pn = clip(torch.linalg.vector_norm(p), floor)
        out.append(u * clip(ratio * pn / (un + 1e-12), hi=1.0))
    return out


class Adam(NamedTuple):
    """optax's ``adam(lr, b1, b2, eps)`` as a pair of functions:
    ``init(params) -> AdamState`` and ``update(grads, state) -> (updates,
    state)``."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return adam_init(params)

    def update(self, grads: Sequence[torch.Tensor], state: AdamState):
        return adam_update(grads, state, self.lr, self.b1, self.b2, self.eps)


@torch.no_grad()
def apply_gated(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor],
                state: AdamState, new_state: AdamState, ok: torch.Tensor) -> AdamState:
    """``optax.apply_updates`` behind ``mptpu``'s ok-gate, on the device:
    each parameter becomes ``p + u`` in place where ``ok`` holds and keeps
    its value where it does not; returns ``new_state`` where ``ok``, else
    ``state`` (the moments and the count alike)."""
    for p, u in zip(params, updates):
        p.copy_(torch.where(ok, p + u, p))
    return AdamState(torch.where(ok, new_state.count, state.count),
                     [torch.where(ok, n, o) for n, o in zip(new_state.mu, state.mu)],
                     [torch.where(ok, n, o) for n, o in zip(new_state.nu, state.nu)])


def adam_state_tree(state: AdamState, names: Sequence[str]) -> dict:
    """The port's checkpoint layout of an Adam state: ``{"count": int,
    "mu": {parameter name: tensor}, "nu": {...}}`` (``save_checkpoint``
    takes the tensors to numpy)."""
    return {"count": int(state.count), "mu": dict(zip(names, state.mu)),
            "nu": dict(zip(names, state.nu))}


def adam_state_from_tree(tree: dict, names: Sequence[str], device) -> AdamState:
    """The inverse of :func:`adam_state_tree`, on ``device``."""
    return AdamState(torch.tensor(int(tree["count"]), dtype=torch.int32, device=device),
                     [torch.as_tensor(tree["mu"][n], device=device) for n in names],
                     [torch.as_tensor(tree["nu"][n], device=device) for n in names])
