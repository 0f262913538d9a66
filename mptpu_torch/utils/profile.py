"""Profiler traces and utilization figures (counterpart of
``mptpu/utils/profile.py``): ``trace`` writes a ``torch.profiler`` Chrome
trace of the enclosed block, ``utilization`` turns a measured time and
counted operations and bytes into shares of the card's peaks, ``timed``
takes the best time of a few calls.

``PEAKS`` is the one table of the cards' peaks that the port's bounds use:
memory bytes/s and float32 operations/s outside the tensor cores, from
NVIDIA's data sheets (SXM ``H100``: 3.35 TB/s, 67 TFLOP/s; at a power
limit below 700 W the card reaches less).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Iterator, Tuple

import torch

PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12), "H100": (3.35e12, 67e12)}
H100_HBM_BYTES_PER_S, H100_PEAK_F32_FLOPS = PEAKS["H100"]


def device_peaks(kind: str) -> Tuple[float, float]:
    """(bytes/s, float32 operations/s) of the card named ``kind``
    (``torch.cuda.get_device_name``), the SXM H100's when the name is not
    in ``PEAKS``."""
    return next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the enclosed block with ``torch.profiler`` (the card's
    activity too when CUDA is there) and write it as a Chrome trace to a
    new ``trace_<ns>.json`` in ``log_dir``, whose path is yielded::

        with profile.trace(out_dir) as path:
            sparse_code_fast(sig, d, fused=True)
            torch.cuda.synchronize()
        print("trace in", path)
    """
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


@dataclass
class Utilization:
    """Achieved against peak for a measured region."""

    wall_s: float
    flops: float
    bytes_moved: float
    mfu: float
    hbm_util: float

    def __str__(self) -> str:
        return (
            f"{self.wall_s*1e3:.2f} ms: "
            f"{self.flops / self.wall_s / 1e12:.2f} TFLOP/s "
            f"(MFU {self.mfu*100:.1f}%), "
            f"{self.bytes_moved / self.wall_s / 1e9:.1f} GB/s "
            f"(HBM {self.hbm_util*100:.1f}%)"
        )


def utilization(wall_s: float, flops: float = 0.0, bytes_moved: float = 0.0,
                peak_flops: float = H100_PEAK_F32_FLOPS,
                peak_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> Utilization:
    """The shares of the peaks that ``flops`` operations and
    ``bytes_moved`` bytes (counted from the work's shapes) reach in
    ``wall_s`` seconds."""
    return Utilization(
        wall_s=wall_s,
        flops=flops,
        bytes_moved=bytes_moved,
        mfu=(flops / wall_s) / peak_flops if flops else 0.0,
        hbm_util=(bytes_moved / wall_s) / peak_bytes_per_s if bytes_moved else 0.0,
    )


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (list, tuple)):
        return any(_on_card(o) for o in out)
    if isinstance(out, dict):
        return any(_on_card(o) for o in out.values())
    return False


def timed(fn, *args, repeats: int = 3) -> float:
    """The best wall time in seconds of ``repeats`` calls ``fn(*args)``,
    each waited for with ``torch.cuda.synchronize`` when its result holds
    a CUDA tensor."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        if _on_card(out):
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best
