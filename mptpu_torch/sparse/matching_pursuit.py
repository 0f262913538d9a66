"""Greedy matching pursuit and dictionary learning (counterpart of
``mptpu/sparse/matching_pursuit.py``).

Events come back as dense ``(n_steps, batch)`` arrays of (atom index,
position, value). Atoms that run past the signal end are clipped: energy
scattered past the end is dropped and reads past the end see zeros.

Beside the coder: the dense feature map of the picked values
(differentiable in them), the loss between two such maps with its
stateful form that learns its own dictionary, and ``AtomPlacement``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import default_device
from ..ops.correlation import mp_correlate
from ..ops.kinks import clip
from ..ops.norms import unit_norm


class SparseCodeResult(NamedTuple):
    """Step-major event list, one event per batch item per step."""

    atom_indices: torch.Tensor  # (n_steps, batch) int32
    positions: torch.Tensor     # (n_steps, batch) int32
    values: torch.Tensor        # (n_steps, batch) float32
    residual: torch.Tensor      # (batch, channels, n_samples)


def _normalize_dict(d: torch.Tensor) -> torch.Tensor:
    """Unit-norm each atom over all non-leading dims."""
    return unit_norm(d.reshape(d.shape[0], -1)).reshape(d.shape)


def _as3d(d: torch.Tensor) -> torch.Tensor:
    return d if d.ndim == 3 else d[:, None, :]


def _subtract_event(residual, atoms, positions, values):
    """Subtract ``values[b] * atoms[b]`` from each (channels, n_samples)
    residual row at ``positions[b]``, clipping anything past the end.

    residual (B, C, n); atoms (B, C, A); positions (B,); values (B,).
    Returns a new tensor.
    """
    batch, channels, n_samples = residual.shape
    atom_size = atoms.shape[-1]
    padded = torch.nn.functional.pad(residual, (0, atom_size))
    rows = torch.arange(batch, device=residual.device)[:, None, None]
    chans = torch.arange(channels, device=residual.device)[None, :, None]
    cols = (positions.long()[:, None] + torch.arange(atom_size, device=residual.device))[:, None, :]
    # product and difference round separately, as mptpu's ``seg - v * atom``
    prod = values[:, None, None] * atoms
    padded[rows, chans, cols] = padded[rows, chans, cols] - prod
    return padded[..., :n_samples]


def sparse_code(
    signal: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    approx=None,
    use_fft: bool = False,
) -> SparseCodeResult:
    """Greedy sparse coding: ``n_steps`` rounds of correlate / pick the
    single best (atom, shift) per batch item / subtract.

    signal: (batch, channels, n_samples) or (batch, n_samples)
    d: (n_atoms, atom_size) or (n_atoms, channels, atom_size), unit-normed
    internally.
    """
    if signal.ndim == 2:
        signal = signal[:, None, :]
    batch, channels, n_samples = signal.shape
    d3 = _normalize_dict(_as3d(d))
    residual = signal
    atoms, positions, values = [], [], []
    for _ in range(n_steps):
        fm = mp_correlate(residual, d3, approx=approx, use_fft=use_fft)
        flat = fm.reshape(batch, -1)
        idx = torch.argmax(flat, dim=-1)
        value = flat.gather(1, idx[:, None])[:, 0]
        atom_index = (idx // n_samples).to(torch.int32)
        position = (idx % n_samples).to(torch.int32)
        residual = _subtract_event(residual, d3[atom_index.long()], position, value)
        atoms.append(atom_index)
        positions.append(position)
        values.append(value)
    return SparseCodeResult(
        torch.stack(atoms), torch.stack(positions), torch.stack(values), residual
    )


def scatter_events(
    atom_indices: torch.Tensor,
    positions: torch.Tensor,
    values: torch.Tensor,
    d: torch.Tensor,
    n_samples: int,
    channels: int = 1,
    batch: int | None = None,
) -> torch.Tensor:
    """Render an event list back to a signal: sum value * atom at each
    position, dropping energy past the signal end."""
    d3 = _as3d(d)
    atom_size = d3.shape[-1]
    S, B = atom_indices.shape
    if batch is None:
        batch = B
    dev = d3.device
    contrib = values[..., None, None] * d3[atom_indices.long()]   # (S, B, C, A)
    padded = torch.zeros((batch, channels, n_samples + atom_size), dtype=contrib.dtype, device=dev)
    window = positions.long()[..., None] + torch.arange(atom_size, device=dev)  # (S, B, A)
    b_idx = torch.arange(B, device=dev)[None, :, None].expand(window.shape)
    for c in range(channels):
        padded[:, c].index_put_((b_idx, window), contrib[:, :, c, :], accumulate=True)
    return padded[..., :n_samples]


def reconstruct_from_events(result: SparseCodeResult, d: torch.Tensor) -> torch.Tensor:
    batch, channels, n_samples = result.residual.shape
    return scatter_events(
        result.atom_indices,
        result.positions,
        result.values,
        _normalize_dict(_as3d(d)),
        n_samples,
        channels=channels,
        batch=batch,
    )


def _first_selection_groups(atom_indices: torch.Tensor):
    """Events grouped by atom, the atoms in first-selection order
    (step-major, batch-minor), each group in event order.

    Returns (atoms, order, bounds): ``atoms[i]`` is the i-th atom to visit
    and ``order[bounds[i]:bounds[i + 1]]`` its flat event indices. The one
    host copy of the event list happens here.
    """
    flat = atom_indices.reshape(-1).cpu().numpy()
    uniq, first = np.unique(flat, return_index=True)
    atoms = uniq[np.argsort(first, kind="stable")]
    rank = np.empty(int(flat.max()) + 1 if flat.size else 0, dtype=np.int64)
    rank[atoms] = np.arange(len(atoms))
    order = np.argsort(rank[flat], kind="stable")
    counts = np.bincount(rank[flat], minlength=len(atoms))
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return atoms.tolist(), order, bounds.tolist()


def dictionary_learning_step(
    signal: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    approx=None,
    use_fft: bool = False,
) -> torch.Tensor:
    """One dictionary-learning sweep: sparse-code the signal, then for each
    used atom in first-selection order add its instances back into the
    update residual, gather the residual segments at their positions, sum
    and unit-norm them into the new atom, and re-subtract the instances
    rendered with the new atom at amplitude ``|value|``.

    The update pass starts from the full signal, not from the coding
    residual, so an atom still sees the contributions of atoms not yet
    visited; later atoms see earlier atoms' updates (Gauss-Seidel). Unused
    atoms keep their value. Energy scattered past the signal end is
    dropped, so gathers past the end read zeros.

    ``mptpu`` runs this as a 512-trip ``fori_loop`` with masks over all
    events; here it is a Python loop over the atoms that were used, each
    with its own events only. Overlapping windows are summed by
    ``index_add_``, on CUDA with atomics and so in no fixed order.
    """
    if signal.ndim == 2:
        signal = signal[:, None, :]
    batch, channels, n_samples = signal.shape
    d3 = _normalize_dict(_as3d(d))
    atom_size = d3.shape[-1]
    dev = signal.device

    if approx is None and not use_fft and channels == 1:
        # the fast engine gives the same events; on a card the fused kernels
        # engage when the shapes pass their gate, else block_argmax
        from .fast_mp import sparse_code_fast

        block = min(512, atom_size) if atom_size >= 128 else 512
        on_card = dev.type != "cpu"
        coded = sparse_code_fast(
            signal, d3[:, 0, :], n_steps=n_steps, block=block,
            fused=on_card, block_argmax=on_card,
        )
    else:
        coded = sparse_code(signal, d3, n_steps=n_steps, approx=approx, use_fft=use_fft)

    atoms, order, bounds = _first_selection_groups(coded.atom_indices)
    order = torch.from_numpy(order).to(dev)
    pos = coded.positions.reshape(-1)[order].long()
    val = coded.values.reshape(-1)[order]
    # flat offsets into the padded update residual of every event's
    # (channels, atom_size) window, events grouped by atom
    row_len = n_samples + atom_size
    rows = (order % batch)[:, None] * channels + torch.arange(channels, device=dev)
    flat = rows[:, :, None] * row_len + (pos[:, None] + torch.arange(atom_size, device=dev))[:, None, :]

    padded = torch.nn.functional.pad(signal, (0, atom_size)).contiguous()
    padded_flat = padded.view(-1)
    dd = d3.clone()
    for a, lo, hi in zip(atoms, bounds[:-1], bounds[1:]):
        idx = flat[lo:hi].reshape(-1)
        v = val[lo:hi, None, None]
        # 1) instances rendered with the coding-time atom go back in
        padded_flat.index_add_(0, idx, (v * dd[a]).reshape(-1))
        padded[:, :, n_samples:] = 0.0
        # 2) the new atom: summed residual segments, unit norm
        summed = padded_flat[idx].reshape(hi - lo, -1).sum(0)
        new_atom = unit_norm(summed).reshape(channels, atom_size)
        dd[a] = new_atom
        # 3) instances rendered with the new atom come out at |value|
        padded_flat.index_add_(0, idx, (v.abs() * new_atom).reshape(-1), alpha=-1)
        padded[:, :, n_samples:] = 0.0

    d_new = _normalize_dict(dd)
    return d_new if d.ndim == 3 else d_new[:, 0, :]


def sparse_feature_map(
    signal: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    approx=None,
    use_fft: bool = False,
    return_residual: bool = False,
):
    """Dense (batch, n_atoms, n_samples) map of the values the naive greedy
    loop picks, each at its (atom, position); differentiable in the values
    (through them into the signal and the dictionary), the positions held
    fixed."""
    if signal.ndim == 2:
        signal = signal[:, None, :]
    batch, channels, n_samples = signal.shape
    d3 = _normalize_dict(_as3d(d))
    rows = torch.arange(batch, device=signal.device)
    residual = signal
    atoms, positions, values = [], [], []
    for _ in range(n_steps):
        flat = mp_correlate(residual, d3, approx=approx, use_fft=use_fft).reshape(batch, -1)
        idx = torch.argmax(flat.detach(), dim=-1)
        # indexing saves only the index and the shape for the backward;
        # torch.gather would keep every step's whole map alive until then
        value = flat[rows, idx]
        atom_index, position = idx // n_samples, idx % n_samples
        residual = _subtract_event(residual, d3[atom_index], position, value)
        atoms.append(atom_index)
        positions.append(position)
        values.append(value)
    # one accumulating scatter of all steps: the sums of mptpu's step-by-step
    # adds, with no dense map per step
    fm = torch.zeros((batch, d3.shape[0], n_samples), dtype=signal.dtype, device=signal.device)
    fm = fm.index_put(
        (rows.expand(n_steps, batch), torch.stack(atoms), torch.stack(positions)),
        torch.stack(values),
        accumulate=True,
    )
    if return_residual:
        return fm, residual
    return fm


def _bce_sum(r_map: torch.Tensor, t_map: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    # jnp.clip's half gradient at a bound (ops/kinks.py): the target map's
    # largest entry over mx is exactly 1 whenever it holds the maximum, and
    # its gradient reaches recon through mx
    r = clip(r_map / mx, 1e-7, 1.0 - 1e-7)
    t = clip(t_map / mx, 0.0, 1.0)
    return torch.sum(-(t * torch.log(r) + (1.0 - t) * torch.log(1.0 - r)))


def sparse_coding_loss(
    recon: torch.Tensor,
    target: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    approx=None,
) -> torch.Tensor:
    """BCE between the max-normalised greedy feature maps of ``recon`` and
    ``target``; no gradient flows into the target's map."""
    r_map = sparse_feature_map(recon, d, n_steps=n_steps, approx=approx)
    with torch.no_grad():
        t_map = sparse_feature_map(target, d, n_steps=n_steps, approx=approx)
    mx = torch.maximum(torch.amax(r_map), torch.amax(t_map))
    # item by item, each item's terms recomputed in the backward: for the
    # whole batch at once autograd would keep a dozen map-sized tensors
    sums = [
        checkpoint(_bce_sum, r, t, mx, use_reentrant=False, preserve_rng_state=False)
        for r, t in zip(r_map.unbind(0), t_map.unbind(0))
    ]
    return torch.stack(sums).sum() / r_map.numel()


def flatten_atom_dict(atom_dict) -> list:
    """Flatten a ``{key: [events...]}`` mapping into one event list."""
    all_instances = []
    for v in atom_dict.values():
        all_instances.extend(v)
    return all_instances


class SparseCodingLoss:
    """Stateful sparse-coding BCE loss: for its first ``learning_steps``
    calls it runs one ``dictionary_learning_step`` on the targets, then it
    scores reconstructions against targets in greedy-feature-map space.

    The dictionary is drawn uniformly in [-1, 1) from ``generator`` (a CPU
    ``torch.Generator``, seeded with 0 when None, as ``mptpu``'s ``seed``)
    and put on ``default_device(device)``. ``mptpu`` draws from
    ``jax.random.PRNGKey(seed)`` and gets other numbers: for parity, set
    ``d`` to ``mptpu``'s through ``mptpu_torch.convert.dictionary_from_jax``.
    """

    def __init__(
        self,
        n_atoms: int,
        atom_size: int,
        n_steps: int,
        approx=None,
        learning_steps: int = 16,
        generator: torch.Generator | None = None,
        device=None,
    ):
        self.approx = approx
        self.n_steps = n_steps
        self.learning_steps = learning_steps
        self._steps_executed = 0
        gen = generator or torch.Generator().manual_seed(0)
        d = torch.rand((n_atoms, atom_size), generator=gen) * 2.0 - 1.0
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
        self.d = d.to(default_device(device))

    def _learning_step(self, signal: torch.Tensor) -> None:
        self.d = dictionary_learning_step(signal, self.d, n_steps=self.n_steps, approx=self.approx)
        self._steps_executed += 1

    def loss(self, recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self._steps_executed < self.learning_steps:
            self._learning_step(target.detach())
        return sparse_coding_loss(recon, target, self.d, n_steps=self.n_steps, approx=self.approx)

    __call__ = loss


class AtomPlacement:
    """Add ``n_events`` rendered events, each ``n_samples`` long, into a
    2 x ``n_samples`` buffer at ``indices * step_size`` and keep the first
    ``n_samples``.

    Starts follow ``mptpu``'s ``lax.dynamic_slice``: a negative start
    counts from the end of the 2 x ``n_samples`` buffer, then every start
    is clamped into ``[0, n_samples]``. So an event whose time passes
    ``n_samples`` lands at ``n_samples``, wholly in the dropped half.
    """

    def __init__(self, n_samples: int, n_events: int, step_size: int):
        self.n_samples = n_samples
        self.n_events = n_events
        self.step_size = step_size

    def render(self, x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        n_samples, n_events = self.n_samples, self.n_events
        x = x.reshape(-1, n_events, n_samples)
        times = indices.reshape(-1, n_events).long() * self.step_size
        times = torch.where(times < 0, times + 2 * n_samples, times).clamp(0, n_samples)
        out = x.new_zeros((x.shape[0], 2 * n_samples))
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        span = torch.arange(n_samples, device=x.device)
        for k in range(n_events):   # in event order, as mptpu's scan adds them
            out = out.index_put((rows, times[:, k, None] + span), x[:, k], accumulate=True)
        return out[:, None, :n_samples]

    __call__ = render
