"""Launch-overhead probe (counterpart of
``scripts/grid_overhead_probe.py``).

``mptpu``'s probe sets 3,200 sequential Pallas grid steps against one
in-kernel loop of 3,200 to find what a grid step costs on the TPU. The
question on a CUDA card is what a launch costs against one iteration of a
loop inside a running kernel, which decides between one launch per greedy
step and a whole-encode kernel. ``probe_launches`` runs either kind
(``csrc/probe.cu``) and returns the (8, 128) float32 tile; the caller
times it. ``probe_plain`` is the same arithmetic in PyTorch ops.
"""

from __future__ import annotations

import torch

from . import kernels
from .device import default_device

TILE = (8, 128)
FACTOR = 1.000001


def probe_plain(vpu: bool, steps: int = 3200, device="cpu") -> torch.Tensor:
    """The tile after ``steps`` updates ``acc = acc * 1.000001 + 1`` from
    zero (product and sum rounded separately in float32), or zeros without
    ``vpu``. The kind does not change the result."""
    acc = torch.zeros(TILE, dtype=torch.float32, device=device)
    if vpu:
        for _ in range(steps):
            acc.mul_(FACTOR).add_(1.0)
    return acc


def probe_launches(kind: str, vpu: bool, steps: int = 3200, device=None,
                   programmatic: bool = False) -> torch.Tensor:
    """Run the probe and return its tile. ``kind="grid"``: ``steps``
    launches of a one-block kernel on the current stream, each (with
    ``vpu``) updating the tile in global memory; with ``programmatic``,
    chained as the port's per-step kernels are (every launch after the first
    may start under the one before it and waits inside before it reads the
    tile). ``kind="fori"``: one launch whose block loops ``steps`` times
    with the tile in registers (``programmatic`` does not apply).

    Runs on the card unless ``device`` is the CPU, where it takes
    ``probe_plain``. One call counts as one entry of
    ``kernels.LAUNCHES["probe_launches"]`` whatever the kind."""
    if kind not in ("grid", "fori"):
        raise ValueError(f"kind is 'grid' or 'fori', got {kind!r}")
    if programmatic and kind != "grid":
        raise ValueError("programmatic applies to kind='grid' only")
    dev = default_device(device)
    if dev.type == "cpu":
        return probe_plain(vpu, steps, dev)
    tile = torch.empty(TILE, dtype=torch.float32, device=dev)
    args = (tile.data_ptr(), int(steps), int(bool(vpu)))
    with torch.cuda.device(dev):
        if kind == "grid":
            kernels.launch("probe_grid", "probe_launches", *args, int(bool(programmatic)))
        else:
            kernels.launch("probe_loop", "probe_launches", *args)
    return tile
