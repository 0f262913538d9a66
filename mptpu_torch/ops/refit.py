"""Joint least-squares amplitude re-projection (counterpart of
``mptpu/ops/refit.py``): the orthogonal-MP fix-up of greedy amplitudes.

One batched ``(E, N) @ (N, E)`` product and an ``E x E`` solve; the greedy
amplitudes lie in the feasible set, so the refit never raises the
waveform error (up to the ridge).
"""

from __future__ import annotations

import torch

from ..device import no_tf32


def refit_gains(
    target: torch.Tensor,
    channels: torch.Tensor,
    ridge: float = 1e-3,
    span: int | None = None,
) -> torch.Tensor:
    """Solve ``min_g || target - sum_i g_i * channels[:, i] ||^2``.

    target: ``(batch, 1, n_samples)``; channels: ``(batch, n_events,
    n_samples)``. ``ridge`` is a Tikhonov weight scaled by the mean channel
    energy, so it is amplitude-invariant and keeps dead (all-zero) channels
    at gain ~0; ``span`` restricts the fit to the first ``span`` samples.
    Returns ``(batch, n_events)`` gains.
    """
    tgt = target[:, 0, :span] if span is not None else target[:, 0]
    ch = channels[..., :span] if span is not None else channels
    with no_tf32():
        gram = torch.einsum("ben,bfn->bef", ch, ch)
        rhs = torch.einsum("ben,bn->be", ch, tgt)
    n_events = channels.shape[1]
    # scale-invariant ridge: mean diagonal energy, plus an absolute epsilon
    # so that an all-silent decode still solves
    trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
    lam = ridge * (trace[:, None, None] / n_events + 1e-12)
    eye = torch.eye(n_events, dtype=gram.dtype, device=gram.device)[None]
    # without the error check, which reads the solver's status on the host:
    # a singular system gives non-finite gains, as jnp.linalg.solve does,
    # and the trainers' gate skips that step
    return torch.linalg.solve_ex(gram + lam * eye, rhs[..., None], check_errors=False)[0][..., 0]
