"""Plain greedy matching pursuit.

The algorithm (the reference repository's ``modules/matchingpursuit.py``):
per step and item, the best (atom, position) of the correlation map
``c[a, t] = sum_k r[t + k] d[a, k]`` of the residual ``r`` against the
unit-norm dictionary ``d``, ``r`` read as zero past its end; the residual
then loses ``c[a, t] * d[a]`` at ``t``, clipped at the end.

``Pursuit`` holds the whole map, positions on rows, and after each event
recomputes the 2A - 1 rows the event touched straight from the residual,
so it needs no gram and no special case at the signal's end. ``follow``
walks a given event list and measures it; ``greedy`` picks its own events.

``tf32=True`` computes the products in TF32 (on a card through cuBLAS, on
the CPU by rounding both operands to TF32's 10-bit mantissa): the control,
one precision below the configuration's float32.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def unit_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rows over their L2 norm, as the algorithm's ``unit_norm``: the
    squared norm clamped below ``eps**2`` and ``eps`` added to the norm."""
    sq = (x * x).sum(-1, keepdim=True)
    return x / (torch.sqrt(torch.clamp(sq, min=eps * eps)) + eps)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits, ties to
    even); finite inputs only."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


@contextmanager
def _tf32_on():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    if not tf32:
        return a @ b
    if a.is_cuda:
        with _tf32_on():
            return a @ b
    return round_tf32(a) @ round_tf32(b)


class Pursuit:
    """Greedy MP state for ``signal`` (B, n) and dictionary ``d`` (N, A),
    both taken in ``dtype`` and ``d`` unit-normed. ``self.map`` is
    (B, n + 2A - 2, N): row ``t + A - 1`` holds position ``t``, and the
    A - 1 rows on either side are -inf."""

    def __init__(self, signal: torch.Tensor, d: torch.Tensor, dtype=torch.float64,
                 tf32: bool = False):
        self.tf32 = tf32
        self.d = unit_norm(d.to(dtype))
        B, n = signal.shape
        N, A = self.d.shape
        self.B, self.n, self.N, self.A = B, n, N, A
        self.scale = torch.linalg.vector_norm(signal.to(dtype), dim=-1)
        # residual at offset A - 1, zeros on both sides, long enough for the
        # windows of every map row
        self.rp = torch.zeros((B, n + 3 * A), dtype=dtype, device=signal.device)
        self.rp[:, A - 1 : A - 1 + n] = signal.to(dtype)
        self.map = torch.full((B, n + 2 * A - 2, N), float("-inf"), dtype=dtype,
                              device=signal.device)
        dt = self.d.T.contiguous()
        for b in range(B):   # item by item, so that the windows fit
            windows = self.rp[b].unfold(0, A, 1)[A - 1 : A - 1 + n]
            self.map[b, A - 1 : A - 1 + n] = matmul(windows, dt, tf32)
        self.rows = torch.arange(B, device=signal.device)

    @property
    def residual(self) -> torch.Tensor:
        return self.rp[:, self.A - 1 : self.A - 1 + self.n]

    def best(self):
        """(value, atom, position) of each item's largest map entry."""
        value, idx = self.map.reshape(self.B, -1).max(-1)
        return value, idx % self.N, idx // self.N - (self.A - 1)

    def value_at(self, atom: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
        return self.map[self.rows, position + self.A - 1, atom]

    def subtract(self, atom: torch.Tensor, position: torch.Tensor, value: torch.Tensor) -> None:
        A, n = self.A, self.n
        dev = self.rp.device
        cols = (A - 1) + position[:, None] + torch.arange(A, device=dev)
        self.rp[self.rows[:, None], cols] -= value[:, None] * self.d[atom]
        self.rp[:, A - 1 + n :] = 0.0
        # map rows position .. position + 2A - 2 hold t = position - A + 1 ..
        # position + A - 1; row u's window starts at residual column u
        u = position[:, None] + torch.arange(2 * A - 1, device=dev)
        windows = self.rp.unfold(1, A, 1)[self.rows[:, None], u]
        new = matmul(windows, self.d.T.contiguous(), self.tf32)
        t = u - (A - 1)
        valid = (t >= 0) & (t < n)
        self.map[self.rows[:, None], u] = torch.where(valid[..., None], new,
                                                      torch.full_like(new, float("-inf")))


def follow(signal: torch.Tensor, d: torch.Tensor, atoms: torch.Tensor, positions: torch.Tensor,
           values: torch.Tensor):
    """Walk the events (each (S, B)) in float64 and measure them.

    Returns (err, residual, ref_values): ``err`` (B,) is each item's
    largest event error, ``max(best - chosen, |value - chosen|)`` over its
    steps over the norm of its signal, where ``chosen`` is the map's entry
    at the given (atom, position) and ``best`` the map's largest; the walk
    subtracts ``chosen`` at each event, so ``residual`` (B, n) and
    ``ref_values`` (S, B) are the reference's along the given path. An
    event out of range, or a value that is not finite, gives an infinite
    error."""
    S, B = atoms.shape
    dev = signal.device
    p = Pursuit(signal, d)
    atoms = atoms.to(dev).long()
    positions = positions.to(dev).long()
    values = values.to(dev).to(torch.float64)
    inf = torch.full((B,), float("inf"), dtype=torch.float64, device=dev)
    err = torch.zeros(B, dtype=torch.float64, device=dev)
    ref_values = torch.zeros((S, B), dtype=torch.float64, device=dev)
    for s in range(S):
        ok = ((atoms[s] >= 0) & (atoms[s] < p.N) & (positions[s] >= 0) & (positions[s] < p.n)
              & torch.isfinite(values[s]))
        a = torch.where(ok, atoms[s], 0)
        t = torch.where(ok, positions[s], 0)
        best = p.best()[0]
        chosen = p.value_at(a, t)
        e = torch.maximum(best - chosen, (values[s] - chosen).abs()) / p.scale
        err = torch.maximum(err, torch.where(ok, e, inf))
        p.subtract(a, t, torch.where(ok, chosen, 0.0))
        ref_values[s] = chosen
    return err, p.residual.clone(), ref_values


def greedy(signal: torch.Tensor, d: torch.Tensor, steps: int, dtype=torch.float64,
           tf32: bool = False):
    """``steps`` greedy events of its own: (atoms, positions, values) each
    (S, B), and the residual (B, n)."""
    p = Pursuit(signal, d, dtype=dtype, tf32=tf32)
    out = []
    for _ in range(steps):
        value, atom, position = p.best()
        p.subtract(atom, position, value)
        out.append((atom, position, value))
    atoms, positions, values = (torch.stack(x) for x in zip(*out))
    return atoms, positions, values, p.residual.clone()


def residual_err(program: torch.Tensor, reference: torch.Tensor, scale: torch.Tensor):
    """(B,) ``|program - reference|_2`` over ``scale``; infinite where the
    program's residual is not finite or has the wrong shape."""
    if tuple(program.shape) != tuple(reference.shape):
        return torch.full_like(scale, float("inf"))
    diff = torch.linalg.vector_norm(program.to(reference.dtype) - reference, dim=-1) / scale
    return torch.where(torch.isfinite(diff), diff, torch.full_like(diff, float("inf")))
