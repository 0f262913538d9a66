"""Fast greedy matching pursuit with incremental correlation updates
(counterpart of ``mptpu/sparse/fast_mp.py``).

After one initial correlation, each greedy step is: argmax over the map,
subtract ``value * gram[atom]`` in a ``2A-1`` window around the event, and
recompute the last ``A`` map positions exactly when the event's atom runs
past the signal end. The engines, selected as in ``mptpu``:

- ``fused=True`` (shapes passing ``fused_step_applicable``): the CUDA
  kernels of ``cuda_fused_mp``. One launch per step, all ``n_steps`` of
  them enqueued by one call: the cluster kernel
  ``cuda_fused_step_pipelined`` (``pipelined=True``, the default) or the
  one-block-per-item ``cuda_fused_step``. ``whole_loop=True``: the whole
  encode in one launch, ``cuda_fused_encode`` or, with ``lane_table=True``,
  ``cuda_fused_encode_lane``.
- otherwise PyTorch ops: flat argmax or ``block_argmax``, with the tail by
  ``F.conv1d`` or, with ``use_pallas``, by ``cuda_boundary_update``.

``depth`` and ``inner_loop`` are accepted and change nothing: they are
scheduling knobs of the TPU kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import no_tf32
from ..ops.correlation import mp_correlate
from ..ops.norms import unit_norm
from ..tracing import span
from .matching_pursuit import SparseCodeResult
from .cuda_mp import cuda_boundary_update
from .cuda_fused_mp import (
    cuda_fused_encode,
    cuda_fused_encode_lane,
    cuda_fused_step,
    cuda_fused_step_pipelined,
    fused_step_applicable,
    kernels_usable,
    _refine,
    _repair_blocks,
    _subtract_residual,
    _subtract_window,
    _tail,
)

# argmax poison for the map's pad regions; gram updates only subtract
# bounded deltas there, so it survives in float32
NEG = -1e30
# lane padding of the block-max table on the whole-loop path; never wins
TABLE_PAD = -3e38


class FastGeometry(NamedTuple):
    """Static layout of the padded correlation map (``fast_mp.py:106-147``)."""

    n_samples: int
    atom_size: int
    block: int
    pad: int          # left pad, a whole number of blocks >= atom_size - 1
    n_blocks: int     # blocks per map row; the map is n_blocks * block wide
    upd_blocks: int   # aligned blocks a (2A-1)-wide update window can straddle
    tail_start: int   # map offset of the last atom_size positions

    @property
    def W(self) -> int:
        return self.n_blocks * self.block

    @property
    def nb_pad(self) -> int:
        """``n_blocks`` rounded up to a multiple of 128."""
        return ((self.n_blocks + 127) // 128) * 128


def fast_geometry(n_samples: int, atom_size: int, block: int) -> FastGeometry:
    pad = ((atom_size - 1 + block - 1) // block) * block
    W = ((n_samples + 2 * pad + block - 1) // block) * block
    return FastGeometry(
        n_samples=n_samples,
        atom_size=atom_size,
        block=block,
        pad=pad,
        n_blocks=W // block,
        upd_blocks=(2 * atom_size - 1 + block - 1) // block + 1,
        tail_start=pad + n_samples - atom_size,
    )


def dictionary_gram(d: torch.Tensor) -> torch.Tensor:
    """(n_atoms, n_atoms, 2*atom_size-1) full-lag auto-correlation,
    ``gram[a, b, A-1 + s] = sum_k d[a, k] * d[b, k - s]``, in full float32."""
    atom_size = d.shape[-1]
    padded = F.pad(d, (atom_size - 1, atom_size - 1))
    with no_tf32():
        return F.conv1d(padded[:, None, :], d[:, None, :])


def encode_state(signal: torch.Tensor, d2: torch.Tensor, geom: FastGeometry):
    """Initial (fm, bm, residual) of the fast engine for ``signal``
    (B, 1, n) and the unit-norm dictionary ``d2`` (N, A): the padded,
    pad-poisoned correlation map, its block maxima and the residual rows
    padded by ``atom_size``."""
    batch = signal.shape[0]
    n_atoms = d2.shape[0]
    fm = mp_correlate(signal, d2)
    fm = F.pad(fm, (geom.pad, geom.W - geom.n_samples - geom.pad), value=NEG)
    bm = fm.reshape(batch, n_atoms, geom.n_blocks, geom.block).amax(-1)
    residual = F.pad(signal[:, 0, :], (0, geom.atom_size))
    return fm, bm, residual


def sparse_code_fast(
    signal: torch.Tensor,
    d: torch.Tensor,
    n_steps: int = 100,
    block: int = 512,
    block_argmax: bool = False,
    use_pallas: bool = False,
    fused: bool = False,
    pipelined: bool = True,
    gate_tail: bool = True,
    whole_loop: bool = False,
    depth: int = 2,
    lane_table: bool = False,
    inner_loop: bool = False,
) -> SparseCodeResult:
    """Drop-in fast path for ``sparse_code`` (1-channel dictionaries); runs
    where ``signal`` lies. ``use_pallas`` keeps ``mptpu``'s name and
    selects the boundary-tail kernel."""
    if signal.ndim == 2:
        signal = signal[:, None, :]
    batch, channels, n_samples = signal.shape
    if channels != 1:
        raise ValueError("the fast path supports single-channel signals")
    d2 = unit_norm(d if d.ndim == 2 else d[:, 0, :])
    n_atoms, atom_size = d2.shape
    dev = signal.device
    geom = fast_geometry(n_samples, atom_size, block)
    kernels = fused and fused_step_applicable(n_samples, atom_size, block, geom.pad, n_atoms, dev)
    whole_loop = kernels and whole_loop and depth + 1 <= batch <= 128
    with span("mptpu.mp.gram"):
        gram = dictionary_gram(d2)
        if kernels:
            gram = F.pad(gram, (0, 1))   # lag axis zero-padded to 2A
    with span("mptpu.mp.state"):
        fm, bm, residual = encode_state(signal, d2, geom)
        if kernels and (pipelined or whole_loop):
            bm = F.pad(bm, (0, geom.nb_pad - geom.n_blocks), value=TABLE_PAD)
        if whole_loop and lane_table:
            # first lane of each block's maximum, 0 in the pad columns
            lanes = torch.argmax(fm.reshape(batch, n_atoms, geom.n_blocks, block), dim=-1)
            lanes = F.pad(lanes.to(torch.int32), (0, geom.nb_pad - geom.n_blocks))

    if kernels:
        with span("mptpu.mp.loop"):
            kw = geom._asdict()
            if whole_loop and lane_table:
                ev = cuda_fused_encode_lane(
                    fm, bm, lanes, residual, d2, gram, n_steps=n_steps, gate_tail=gate_tail, **kw
                )
            elif whole_loop:
                ev = cuda_fused_encode(
                    fm, bm, residual, d2, gram, n_steps=n_steps, gate_tail=gate_tail, **kw
                )
            else:
                step = cuda_fused_step_pipelined if pipelined else cuda_fused_step
                ev = step(fm, bm, residual, d2, gram, gate_tail=gate_tail, n_steps=n_steps, **kw)
        return SparseCodeResult(ev[0], ev[1], ev[2], residual[:, None, :n_samples])
    if fused:
        # the fused gate failed: the next-best engine
        block_argmax = True

    with span("mptpu.mp.loop"):
        A, pad, W = atom_size, geom.pad, geom.W
        use_pallas = (
            use_pallas
            and kernels_usable(dev)
            and geom.tail_start % A == 0
            and A % block == 0
            and n_atoms % 8 == 0
        )
        rows = torch.arange(batch, device=dev)
        tail_starts = n_samples - A + torch.arange(A, device=dev)
        tail_idx = tail_starts[:, None] + torch.arange(A, device=dev)[None, :]
        tail_lo = (pad + n_samples - A) // block
        tail_nblk = (pad + n_samples - 1) // block - tail_lo + 1

        out = []
        for _ in range(n_steps):
            if block_argmax:
                midx = torch.argmax(bm.reshape(batch, -1), dim=-1)
                atom = midx // geom.n_blocks
                value, position = _refine(fm, atom, midx % geom.n_blocks, block, pad)
            else:
                flat = fm.reshape(batch, -1)
                idx = torch.argmax(flat, dim=-1)
                value = flat[rows, idx]
                atom = idx // W
                position = idx % W - pad

            _subtract_residual(residual, d2, atom, position, value, n_samples)
            ustart = position + pad - (A - 1)
            _subtract_window(fm, gram[atom], ustart, value)

            if use_pallas:
                cuda_boundary_update(fm, bm, residual[:, tail_idx], d2, geom.tail_start, block)
            else:
                tail_fm = _tail(residual, d2, n_samples)
                fm[:, :, geom.tail_start : geom.tail_start + A] = tail_fm
                if block_argmax:
                    if geom.tail_start % block == 0 and A % block == 0:
                        tail_max = tail_fm.reshape(batch, n_atoms, A // block, block).amax(-1)
                    else:
                        # the tail straddles block edges: reduce from the map
                        tail_max = fm[:, :, tail_lo * block : (tail_lo + tail_nblk) * block]
                        tail_max = tail_max.reshape(batch, n_atoms, tail_nblk, block).amax(-1)
                    bm[:, :, tail_lo : tail_lo + tail_nblk] = tail_max

            if block_argmax:
                ublk0 = torch.clamp(ustart // block, max=geom.n_blocks - geom.upd_blocks)
                _repair_blocks(fm, bm, ublk0, geom.upd_blocks, block)

            out.append((atom.to(torch.int32), position.to(torch.int32), value))

        atoms, positions, values = (torch.stack(x) for x in zip(*out))
    return SparseCodeResult(atoms, positions, values, residual[:, None, :n_samples])
