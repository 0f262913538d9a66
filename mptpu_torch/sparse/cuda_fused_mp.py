"""Fused greedy fast-MP step and whole encode (counterpart of
``mptpu/sparse/pallas_fused_mp.py``).

One greedy step for every batch item, in place on the correlation map
``fm`` (B, N, W), the block-max table ``bm`` (B, N, n_blocks or
lane-padded) and the padded residual rows (B, n_samples + A):

1. first-flat-index argmax over the item's block-max table;
2. refine inside the winning block (smallest lane wins);
3. subtract ``value * d2[atom]`` from the residual, zero it past the end;
4. if the event clipped (or always, without ``gate_tail``): the exact
   tail ``tail[a, p] = sum_k d2[a, k] * residual[n - A + p + k]``;
5. ``fm[b, :, ustart : ustart + 2A] -= value * gram_p[atom]``;
6. the tail overwrites ``fm[b, :, tail_start : tail_start + A]``;
7. the maxima of every window block and tail block are taken again.

``cuda_fused_step`` launches that once per step with one thread block
per item; ``cuda_fused_step_pipelined`` is the same function with each
item's step shared by a thread-block cluster; both take ``n_steps`` and
then enqueue that many launches in one call, events stacked (n_steps, B);
``cuda_fused_encode`` runs
all ``n_steps`` in one launch, one cluster per item looping over the steps;
``cuda_fused_encode_lane`` does so too, with a table of each block's
first-maximum lane beside ``bm``, so that selecting reads no map block.
Their plain PyTorch versions (``fused_step_plain``,
``fused_encode_plain``, ``fused_encode_lane_plain``) sit here too; a CPU
tensor takes them. On a CUDA tensor the wrappers launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..device import no_tf32


class StepEvents(NamedTuple):
    """Events of one step (B,) or of a whole encode (n_steps, B)."""

    atoms: torch.Tensor      # int32
    positions: torch.Tensor  # int32
    values: torch.Tensor     # float32


def kernels_usable(device) -> bool:
    """Whether the fused step has an implementation for tensors on
    ``device``: the plain version on the CPU, the kernels on CUDA."""
    return torch.device(device).type in ("cpu", "cuda")


def fused_step_applicable(
    n_samples: int, atom_size: int, block: int, pad: int, n_atoms: int, device
) -> bool:
    """The same static gate as ``mptpu``'s
    (``pallas_fused_mp.py:1815-1834``), with "Pallas available" replaced
    by "kernels usable for ``device``"."""
    if not kernels_usable(device):
        return False
    tail_start = pad + n_samples - atom_size
    upd_blocks = (2 * atom_size - 1 + block - 1) // block + 1
    return (
        atom_size % block == 0
        and atom_size % 128 == 0
        and block % 128 == 0
        and n_samples % 128 == 0
        and tail_start % block == 0
        and (atom_size & (atom_size - 1)) == 0
        and n_atoms % 8 == 0
        and upd_blocks * block >= 2 * atom_size
    )


# ---- pieces shared with the torch-op engine in fast_mp.py


def _refine(fm, atom, blk, block: int, pad: int):
    """(value, position) of the first maximum inside block ``blk`` of row
    ``atom`` of each item's map."""
    rows = torch.arange(fm.shape[0], device=fm.device)[:, None]
    cols = blk[:, None] * block + torch.arange(block, device=fm.device)
    seg = fm[rows, atom[:, None], cols]
    li = torch.argmax(seg, dim=-1)
    value = seg.gather(1, li[:, None])[:, 0]
    return value, blk * block + li - pad


def _subtract_residual(residual, d2, atom, position, value, n_samples: int) -> None:
    """In place: ``residual[b, p:p+A] -= value * d2[atom]``, then zero past
    ``n_samples``. Product and difference round separately."""
    rows = torch.arange(residual.shape[0], device=residual.device)[:, None]
    cols = position[:, None] + torch.arange(d2.shape[-1], device=residual.device)
    prod = value[:, None] * d2[atom]
    residual[rows, cols] = residual[rows, cols] - prod
    residual[:, n_samples:] = 0.0


def _subtract_window(fm, gram_rows, ustart, value) -> None:
    """In place: ``fm[b, :, u : u + width] -= value * gram_rows[b]`` with
    ``u = ustart[b]`` and ``gram_rows`` (B, N, width)."""
    B, N, width = gram_rows.shape
    dev = fm.device
    idx = (
        torch.arange(B, device=dev)[:, None, None],
        torch.arange(N, device=dev)[None, :, None],
        (ustart[:, None] + torch.arange(width, device=dev))[:, None, :],
    )
    prod = value[:, None, None] * gram_rows
    fm[idx] = fm[idx] - prod


def _tail(residual, d2, n_samples: int):
    """Exact tail (B, N, A): ``sum_k d2[a, k] * residual[b, n - A + p + k]``."""
    A = d2.shape[-1]
    seg = residual[:, n_samples - A : n_samples + A - 1]
    with no_tf32():
        return F.conv1d(seg[:, None, :], d2[:, None, :])


def _repair_blocks(fm, bm, first_blk, n_blk: int, block: int, lanes=None) -> None:
    """In place: ``bm[b, :, first_blk[b] + k]`` = max of that map block,
    for k < n_blk; with ``lanes``, the first lane of that maximum too."""
    B, N, _ = fm.shape
    dev = fm.device
    rows = torch.arange(B, device=dev)[:, None, None]
    atoms = torch.arange(N, device=dev)[None, :, None]
    cols = first_blk[:, None] * block + torch.arange(n_blk * block, device=dev)
    maxima, first = fm[rows, atoms, cols[:, None, :]].reshape(B, N, n_blk, block).max(-1)
    blks = (first_blk[:, None] + torch.arange(n_blk, device=dev))[:, None, :]
    bm[rows, atoms, blks] = maxima
    if lanes is not None:
        lanes[rows, atoms, blks] = first.to(lanes.dtype)


# ---- plain versions


def fused_step_plain(
    fm, bm, residual, d2, gram_p, *, n_samples: int, atom_size: int, block: int,
    pad: int, n_blocks: int, upd_blocks: int, tail_start: int, gate_tail: bool = True,
) -> StepEvents:
    """One fused step in PyTorch ops, in place on ``fm``, ``bm`` and
    ``residual``; the same function as ``cuda_fused_step`` and as
    ``cuda_fused_step_pipelined``, whose plain version it is too."""
    B = fm.shape[0]
    nbt = bm.shape[-1]
    midx = torch.argmax(bm.reshape(B, -1), dim=-1)   # lane pads never win
    atom = midx // nbt
    value, position = _refine(fm, atom, midx % nbt, block, pad)
    return _apply_event(fm, bm, None, residual, d2, gram_p, atom, position, value,
                        n_samples, atom_size, block, pad, n_blocks, upd_blocks, tail_start,
                        gate_tail)


def _apply_event(fm, bm, lanes, residual, d2, gram_p, atom, position, value, n_samples,
                 atom_size, block, pad, n_blocks, upd_blocks, tail_start, gate_tail) -> StepEvents:
    """Steps 3-7 for the selected events, in place; ``lanes`` (or None) is
    repaired beside ``bm``."""
    A = atom_size
    _subtract_residual(residual, d2, atom, position, value, n_samples)

    ustart = position + pad - (A - 1)
    _subtract_window(fm, gram_p[atom], ustart, value)
    clipped = position > n_samples - A if gate_tail else torch.ones_like(position, dtype=torch.bool)
    sel = clipped.nonzero()[:, 0]
    if sel.numel():
        tail = _tail(residual[sel], d2, n_samples)
        fm[sel, :, tail_start : tail_start + A] = tail
    ws_blk = torch.clamp(ustart // block, max=n_blocks - upd_blocks)
    _repair_blocks(fm, bm, ws_blk, upd_blocks, block, lanes)
    if sel.numel():
        t0 = tail_start // block
        maxima, first = tail.reshape(sel.numel(), -1, A // block, block).max(-1)
        bm[sel, :, t0 : t0 + A // block] = maxima
        if lanes is not None:
            lanes[sel, :, t0 : t0 + A // block] = first.to(lanes.dtype)
    return StepEvents(atom.to(torch.int32), position.to(torch.int32), value)


def fused_encode_plain(
    fm, bm, residual, d2, gram_p, *, n_steps: int, gate_tail: bool = True, **geometry
) -> StepEvents:
    """``n_steps`` of ``fused_step_plain``; events stacked (n_steps, B)."""
    steps = [
        fused_step_plain(fm, bm, residual, d2, gram_p, gate_tail=gate_tail, **geometry)
        for _ in range(n_steps)
    ]
    return StepEvents(*(torch.stack(x) for x in zip(*steps)))


def fused_encode_lane_plain(
    fm, bm, lanes, residual, d2, gram_p, *, n_steps: int, block: int, pad: int,
    gate_tail: bool = True, **geometry
) -> StepEvents:
    """``n_steps`` greedy steps that select from the tables alone, in place
    on ``fm``, ``bm``, ``lanes`` and ``residual``: the winner's value is its
    ``bm`` entry and its position ``blk * block + lanes[b, atom, blk] - pad``
    (no map block is read), and the window and tail repairs rewrite both
    tables. The same function as ``cuda_fused_encode_lane``."""
    B = fm.shape[0]
    nbt = bm.shape[-1]
    rows = torch.arange(B, device=fm.device)
    steps = []
    for _ in range(n_steps):
        flat = bm.reshape(B, -1)
        midx = torch.argmax(flat, dim=-1)
        atom, blk = midx // nbt, midx % nbt
        value = flat[rows, midx]
        position = blk * block + lanes[rows, atom, blk].long() - pad
        steps.append(_apply_event(
            fm, bm, lanes, residual, d2, gram_p, atom, position, value,
            block=block, pad=pad, gate_tail=gate_tail, **geometry,
        ))
    return StepEvents(*(torch.stack(x) for x in zip(*steps)))


# blocks per item that the cluster step kernel takes (csrc/mp_window.cuh:
# kMaxStepCluster; above 8 the clusters are "non-portable" ones, which an
# H100 holds)
STEP_CLUSTERS = (16, 8, 4, 2, 1)


def cluster_size(batch: int, n_atoms: int, resident) -> int:
    """Thread blocks per item for ``cuda_fused_step_pipelined``: the one of
    16, 8, 4, 2, 1 (divisors of ``n_atoms`` only) with the least
    ``waves * (1 / size + 1 / 16)``, the larger among equals, where
    ``waves`` is how many rounds ``batch`` clusters need when the card holds
    ``resident(size)`` of them at once. A launch is one step; a wave costs a
    cluster its share of an item's step, 1 / size of one block's time, and a
    part that does not shrink (select, cluster barrier, the wave's start).
    The 1/16 for that part is no model: it is fitted to the sweeps of the
    cluster sizes on an H100 at two batches only, 4 items (a multiband band)
    and 32 (the bench shapes), and at 32 items it leaves 2 and 8 level, which
    the tie-break settles as the sweep does. So 4 items take 16 blocks each,
    and 32 items 8 blocks each in three waves of 15 clusters rather than 4 in
    two waves of 30 or 16 in five waves of 7."""
    best, best_cost = 1, None
    for c in STEP_CLUSTERS:
        if n_atoms % c:
            continue
        held = resident(c)
        if held < 1:
            continue
        cost = -(-batch // held) * (1 / c + 1 / 16)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


class StepPlan(NamedTuple):
    """How ``cuda_fused_step_pipelined``'s kernel runs at a cluster size."""

    clusters: int    # resident at once (0: the shapes admit no such plan)
    stages: int      # depth of the ring of (window, gram row) stages
    smem_bytes: int


@lru_cache(maxsize=None)
def step_plan(n_atoms: int, atom_size: int, block: int, n_blocks: int, upd_blocks: int,
              cluster: int) -> StepPlan:
    """The cluster step kernel's plan on the current card (CUDA's occupancy
    query, no launch) with ``cluster`` blocks per item; a launch of more
    items than ``clusters`` runs in waves."""
    out = (ctypes.c_int * 3)()
    err = kernels.library().mp_fused_step_pipelined_plan(
        n_atoms, atom_size, block, n_blocks, upd_blocks, cluster, out)
    if err != 0:
        raise RuntimeError(f"mp_fused_step_pipelined_plan: CUDA error {err}")
    return StepPlan(out[0], out[1], out[2])


class EncodePlan(NamedTuple):
    """How ``cuda_fused_encode``'s kernel lays out one block's shared memory
    at a cluster size, and how many such clusters the card holds at once."""

    clusters: int        # resident at once (0: the shapes admit no such plan)
    stages: int          # depth of the ring of (window, gram row) stages
    table_on_chip: bool  # the rank's share of the block-max table in shared memory
    smem_bytes: int


@lru_cache(maxsize=None)
def encode_plan(n_atoms: int, atom_size: int, block: int, n_blocks: int, upd_blocks: int,
                cluster: int, lanes: bool = False) -> EncodePlan:
    """The whole-encode kernel's plan on the current card (CUDA's occupancy
    query, no launch) with ``cluster`` blocks per item; with ``lanes``, the
    lane-table encode's (``table_on_chip``: both tables)."""
    name = "mp_fused_encode_lane_plan" if lanes else "mp_fused_encode_plan"
    out = (ctypes.c_int * 4)()
    err = getattr(kernels.library(), name)(
        n_atoms, atom_size, block, n_blocks, upd_blocks, cluster, out)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return EncodePlan(out[0], out[1], bool(out[2]), out[3])


def encode_cluster_size(batch: int, n_atoms: int, resident) -> int:
    """Thread blocks per item for ``cuda_fused_encode``: the largest of 8, 4,
    2, 1 that divides ``n_atoms`` and whose ``batch`` clusters the card holds
    all at once, ``resident(c)`` being how many clusters of ``c`` blocks it
    holds. The kernel loops over every step of the encode, so a second wave
    of clusters would double its time; 1 when nothing else fits."""
    for c in (8, 4, 2):
        if n_atoms % c == 0 and resident(c) >= batch:
            return c
    return 1


def check_bulk_copy_alignment(fm, gram_p, atom_size: int, block: int) -> None:
    """Raise unless the fused kernels' bulk copies are legal: an
    update window of ``fm`` and a row of ``gram_p`` must start on 16 bytes
    and be a multiple of 16 bytes long."""
    if block % 4 or atom_size % 4:
        raise ValueError("block and atom_size must be multiples of 4 (16-byte bulk copies)")
    for name, t in (("fm", fm), ("gram_p", gram_p)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: storage must start on a 16-byte boundary")


# ---- kernel wrappers


def _check_step_args(fm, bm, residual, d2, gram_p, n_samples, atom_size, block, pad,
                     n_blocks, upd_blocks, tail_start):
    B, N, W = fm.shape
    A = atom_size
    dev = fm.device
    if W != n_blocks * block or not fused_step_applicable(n_samples, A, block, pad, N, dev):
        raise ValueError("shapes fail the fused-step gate")
    kernels.check("fm", fm, (B, N, W), device=dev)
    kernels.check("bm", bm, (B, N, bm.shape[-1]), device=dev)
    if bm.shape[-1] < n_blocks:
        raise ValueError("bm: fewer columns than map blocks")
    kernels.check("residual", residual, (B, n_samples + A), device=dev)
    kernels.check("d2", d2, (N, A), device=dev)
    kernels.check("gram_p", gram_p, (N, N, 2 * A), device=dev)
    return B, N, W


def _launch_step(name, counter, fm, bm, residual, d2, gram_p, n_out, gate_tail, geometry,
                 *extra, lanes=None, chain: int = 0) -> StepEvents:
    """One C call: check the arguments, allocate the scratch and the events
    (``n_out``), launch. ``chain``: the call enqueues that many launches of a
    per-step kernel, which share the scratch and one more of 2 x B x N words
    for the rows' maxima; 0: one launch of another kernel."""
    B, N, W = _check_step_args(fm, bm, residual, d2, gram_p, **geometry)
    A = geometry["atom_size"]
    dev = fm.device
    tables = (bm,)
    if lanes is not None:
        kernels.check("lanes", lanes, tuple(bm.shape), dtype=torch.int32, device=dev)
        tables = (bm, lanes)
    scratch = [torch.empty((B, N, A), dtype=torch.float32, device=dev)]
    if chain:
        check_bulk_copy_alignment(fm, gram_p, A, geometry["block"])
        scratch.append(torch.empty((2, B, N), dtype=torch.float32, device=dev))
    atoms = torch.empty(n_out, dtype=torch.int32, device=dev)
    positions = torch.empty(n_out, dtype=torch.int32, device=dev)
    values = torch.empty(n_out, dtype=torch.float32, device=dev)
    kernels.launch(
        name, counter,
        *(t.data_ptr() for t in (fm, *tables, residual, d2, gram_p, *scratch, atoms, positions,
                                 values)),
        B, N, A, W, geometry["n_samples"], geometry["block"], geometry["pad"],
        geometry["n_blocks"], bm.shape[-1], geometry["upd_blocks"], geometry["tail_start"],
        int(gate_tail), *extra,
        count=chain or 1,
    )
    return StepEvents(atoms, positions, values)


def _steps_plain(fm, bm, residual, d2, gram_p, n_steps, gate_tail, geometry) -> StepEvents:
    if n_steps is None:
        return fused_step_plain(fm, bm, residual, d2, gram_p, gate_tail=gate_tail, **geometry)
    return fused_encode_plain(fm, bm, residual, d2, gram_p, n_steps=n_steps, gate_tail=gate_tail,
                              **geometry)


def _check_n_steps(n_steps) -> None:
    if n_steps is not None and n_steps < 1:
        raise ValueError("n_steps must be at least 1")


def cuda_fused_step(
    fm, bm, residual, d2, gram_p, *, gate_tail: bool = True, n_steps: int | None = None,
    programmatic: bool = True, **geometry
) -> StepEvents:
    """One greedy step for every item, in place on ``fm``, ``bm`` and
    ``residual``. ``geometry``: n_samples, atom_size, block, pad, n_blocks,
    upd_blocks, tail_start (``fast_mp.fast_geometry``). Events are (B,).
    With ``n_steps``: that many steps one after another, events
    (n_steps, B); the state after them is the state after as many single
    calls, bit for bit.

    CPU tensors take ``fused_step_plain`` (looped); CUDA tensors launch
    ``csrc/mp_fused.cu:mp_fused_step`` (one thread block per item), the
    ``n_steps`` launches enqueued by one C call and, unless ``programmatic``
    is off, each allowed to start under the one before it (programmatic
    stream serialization; the kernel waits before it reads the state)."""
    _check_n_steps(n_steps)
    if fm.device.type == "cpu":
        return _steps_plain(fm, bm, residual, d2, gram_p, n_steps, gate_tail, geometry)
    B = fm.shape[0]
    return _launch_step("mp_fused_step", "cuda_fused_step", fm, bm, residual, d2, gram_p,
                        (B,) if n_steps is None else (n_steps, B), gate_tail, geometry,
                        n_steps or 1, int(programmatic), chain=n_steps or 1)


def _check_encode_cluster(cluster, n_atoms: int) -> None:
    if cluster is not None and (cluster not in (1, 2, 4, 8) or n_atoms % cluster):
        raise ValueError(f"cluster must be 1, 2, 4 or 8 and divide {n_atoms} atoms")


def _encode_cluster(cluster, fm, gram_p, geometry, lanes: bool) -> int:
    """``cluster``, or by default ``encode_cluster_size`` over the kernel's
    plan; raises unless the bulk copies are legal."""
    B, N = fm.shape[:2]
    if cluster is None:
        shapes = (N, geometry["atom_size"], geometry["block"], geometry["n_blocks"],
                  geometry["upd_blocks"])
        cluster = encode_cluster_size(B, N, lambda c: encode_plan(*shapes, c, lanes).clusters)
    check_bulk_copy_alignment(fm, gram_p, geometry["atom_size"], geometry["block"])
    return cluster


def cuda_fused_encode(
    fm, bm, residual, d2, gram_p, *, n_steps: int, gate_tail: bool = True,
    cluster: int | None = None, **geometry
) -> StepEvents:
    """The whole ``n_steps`` greedy loop, in place on ``fm``, ``bm`` and
    ``residual``; events are (n_steps, B).

    CPU tensors take ``fused_encode_plain``; CUDA tensors launch
    ``csrc/mp_fused.cu:mp_fused_encode`` once: one thread-block cluster per
    item looping over the steps, each of its ``cluster`` blocks (1, 2, 4 or
    8 and a divisor of N) owning ``N / cluster`` atom rows. By default
    ``encode_cluster_size`` picks the largest cluster whose B clusters the
    card holds at once (``encode_plan``). The result does not depend on
    ``cluster``."""
    _check_encode_cluster(cluster, fm.shape[1])
    if fm.device.type == "cpu":
        return fused_encode_plain(
            fm, bm, residual, d2, gram_p, n_steps=n_steps, gate_tail=gate_tail, **geometry
        )
    cluster = _encode_cluster(cluster, fm, gram_p, geometry, lanes=False)
    # shapes whose plan does not fit shared memory fail in the launcher,
    # which the wrapper raises on
    return _launch_step("mp_fused_encode", "cuda_fused_encode", fm, bm, residual, d2, gram_p,
                        (n_steps, fm.shape[0]), gate_tail, geometry, n_steps, cluster)


def cuda_fused_step_pipelined(
    fm, bm, residual, d2, gram_p, *, gate_tail: bool = True, cluster: int | None = None,
    n_steps: int | None = None, programmatic: bool = True, **geometry
) -> StepEvents:
    """``cuda_fused_step``'s function, bit for bit, with each item's step
    shared by a thread-block cluster so that a small batch still fills the
    card (counterpart of ``pallas_fused_step_pipelined``, which overlaps
    items on the TPU's sequential grid for the same reason).

    ``n_steps`` and ``programmatic`` as in ``cuda_fused_step``.

    CPU tensors take ``fused_step_plain`` (looped); CUDA tensors launch
    ``csrc/mp_pipelined.cu:mp_fused_step_pipelined`` with ``cluster`` blocks
    per item (1, 2, 4, 8 or 16 and a divisor of N; by default ``cluster_size``
    with the clusters ``step_plan`` says the card holds at once), each owning
    ``N / cluster`` atom rows. The result does not depend on ``cluster``."""
    _check_n_steps(n_steps)
    B, N = fm.shape[:2]
    if cluster is not None and (cluster not in STEP_CLUSTERS or N % cluster):
        raise ValueError(f"cluster must be 1, 2, 4, 8 or 16 and divide {N} atoms")
    if fm.device.type == "cpu":
        return _steps_plain(fm, bm, residual, d2, gram_p, n_steps, gate_tail, geometry)
    if cluster is None:
        shapes = (N, geometry["atom_size"], geometry["block"], geometry["n_blocks"],
                  geometry["upd_blocks"])
        cluster = cluster_size(B, N, lambda c: step_plan(*shapes, c).clusters)
    return _launch_step("mp_fused_step_pipelined", "cuda_fused_step_pipelined", fm, bm, residual,
                        d2, gram_p, (B,) if n_steps is None else (n_steps, B), gate_tail,
                        geometry, n_steps or 1, int(programmatic), cluster, chain=n_steps or 1)


def cuda_fused_encode_lane(
    fm, bm, lanes, residual, d2, gram_p, *, n_steps: int, gate_tail: bool = True,
    cluster: int | None = None, **geometry
) -> StepEvents:
    """The whole ``n_steps`` greedy loop selecting from ``bm`` and the int32
    table ``lanes`` (same shape as ``bm``; first lane of each block's
    maximum, 0 in pad columns), in place on ``fm``, ``bm``, ``lanes`` and
    ``residual``; events are (n_steps, B) and equal ``cuda_fused_encode``'s.

    CPU tensors take ``fused_encode_lane_plain``; CUDA tensors launch
    ``csrc/mp_lane.cu:mp_fused_encode_lane`` once: ``cuda_fused_encode``'s
    clusters, ``cluster`` blocks per item (1, 2, 4 or 8 and a divisor of N;
    by default ``encode_cluster_size`` over ``encode_plan(..., lanes=True)``).
    The result does not depend on ``cluster``."""
    _check_encode_cluster(cluster, fm.shape[1])
    if fm.device.type == "cpu":
        return fused_encode_lane_plain(
            fm, bm, lanes, residual, d2, gram_p, n_steps=n_steps, gate_tail=gate_tail, **geometry
        )
    cluster = _encode_cluster(cluster, fm, gram_p, geometry, lanes=True)
    return _launch_step("mp_fused_encode_lane", "cuda_fused_encode_lane", fm, bm, residual, d2,
                        gram_p, (n_steps, fm.shape[0]), gate_tail, geometry, n_steps, cluster,
                        lanes=lanes)
