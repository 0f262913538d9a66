"""Boundary-tail recompute of the unfused fast-MP path (counterpart of
``mptpu/sparse/pallas_mp.py``).

Every step of the unfused engine ends by recomputing the last
``atom_size`` map positions exactly (the gram update is wrong there for
clipped events, see ``fast_mp.py``). ``cuda_boundary_update`` does it in
one CUDA kernel (``csrc/mp_boundary.cu``, a register-tiled f32 product fed
by a ring of asynchronous copies): the product, the in-place map write and
the per-block maxima. ``boundary_update_plain`` is the same
function in PyTorch ops; a CPU tensor takes it.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import no_tf32


def _tail_geometry(fm, d, tail_start, block):
    batch, n_atoms, W = fm.shape
    atom_size = d.shape[-1]
    if tail_start % block or atom_size % block or tail_start % atom_size:
        raise ValueError("the tail must be whole blocks, aligned to atom_size in fm")
    return batch, n_atoms, W, atom_size


def check_copy_alignment(windows, d) -> None:
    """Raise unless the kernel's 16-byte copies along the taps are legal:
    rows of ``windows`` and ``d`` must be a multiple of 4 floats long and
    the tensors must start on 16 bytes."""
    if d.shape[-1] % 4:
        raise ValueError("atom_size must be a multiple of 4 (16-byte copies along the taps)")
    for name, t in (("windows", windows), ("d", d)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: storage must start on a 16-byte boundary")


def boundary_update_plain(fm, bm, windows, d, tail_start: int, block: int):
    """Plain PyTorch version: ``fm[:, :, tail_start:tail_start+A]`` and its
    block maxima in ``bm`` are replaced, in place, by the exact tail
    ``tail[b, n, t] = sum_k windows[b, t, k] * d[n, k]``. Returns (fm, bm)."""
    batch, n_atoms, _, atom_size = _tail_geometry(fm, d, tail_start, block)
    with no_tf32():
        tail = torch.matmul(d, windows.transpose(1, 2))   # (B, N, A)
    fm[:, :, tail_start : tail_start + atom_size] = tail
    t0 = tail_start // block
    bm[:, :, t0 : t0 + atom_size // block] = tail.reshape(
        batch, n_atoms, atom_size // block, block
    ).amax(-1)
    return fm, bm


def cuda_boundary_update(fm, bm, windows, d, tail_start: int, block: int):
    """Exact boundary tail, in place on ``fm`` (B, N, W) and ``bm``
    (B, N, n_blocks or lane-padded), from the residual-tail Hankel
    ``windows`` (B, A, A) and the unit-norm dictionary ``d`` (N, A).

    A CPU tensor takes ``boundary_update_plain``; a CUDA tensor launches
    the kernel (``csrc/mp_boundary.cu``) or raises. Returns (fm, bm)."""
    if fm.device.type == "cpu":
        return boundary_update_plain(fm, bm, windows, d, tail_start, block)
    batch, n_atoms, W, atom_size = _tail_geometry(fm, d, tail_start, block)
    dev = fm.device
    kernels.check("fm", fm, (batch, n_atoms, W), device=dev)
    kernels.check("windows", windows, (batch, atom_size, atom_size), device=dev)
    kernels.check("d", d, (n_atoms, atom_size), device=dev)
    check_copy_alignment(windows, d)
    if bm.device != dev or bm.dtype != torch.float32:
        raise ValueError("bm: expected a float32 tensor on the map's device")
    tmax = torch.empty((batch, n_atoms, atom_size // block), dtype=torch.float32, device=dev)
    kernels.launch(
        "mp_boundary_update", "cuda_boundary_update",
        windows.data_ptr(), d.data_ptr(), fm.data_ptr(), tmax.data_ptr(),
        batch, n_atoms, atom_size, W, tail_start, block,
    )
    t0 = tail_start // block
    bm[:, :, t0 : t0 + atom_size // block] = tmax
    return fm, bm
