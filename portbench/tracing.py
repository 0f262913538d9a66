"""A traced stretch of calls and what the per-layer readers take from it.

``profile_calls`` runs calls under ``torch.profiler`` inside one
``portbench.window`` annotation and exports the Chrome trace to a
temporary directory (under ``TMPDIR``), which it reads and deletes.
``Trace`` holds the device's kernels, copies and sets, the host's events,
the window's interval on the trace's clock, the calls made and the work the
entry says they need. Busy time is the union of the device intervals
inside the window, not the sum of their durations: under programmatic
stream serialization a step kernel starts while the step before it runs.
"""

from __future__ import annotations

import json
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

WINDOW = "portbench.window"
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

# the program's greedy-loop kernels: function name -> its launch counter in
# mptpu_torch.kernels.LAUNCHES
LOOP_KERNELS = {
    "fused_step_kernel": "cuda_fused_step",
    "fused_encode_kernel": "cuda_fused_encode",
    "fused_step_pipelined_kernel": "cuda_fused_step_pipelined",
    "fused_encode_lane_kernel": "cuda_fused_encode_lane",
    "boundary_kernel": "cuda_boundary_update",
}
K2 = "fused_encode_kernel"
K4 = "fused_step_pipelined_kernel"


def base_name(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    arguments and parameters."""
    head = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def union_s(spans) -> float:
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / 1e6


@dataclass
class Trace:
    device: list            # (name, start us, duration us, category)
    host: list              # (name, start us, duration us, category)
    window: tuple           # (start us, end us) on the trace's clock
    calls: int
    needed: dict            # the entry's counts of the work the calls need
    peaks: tuple            # (memory bytes/s, float32 operations/s)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _inside(self, keep=lambda name, cat: True):
        w0, w1 = self.window
        for name, ts, dur, cat in self.device:
            if keep(name, cat) and ts + dur > w0 and ts < w1:
                yield max(ts, w0), min(ts + dur, w1)

    def busy_s(self, keep=lambda name, cat: True) -> float:
        return union_s(self._inside(keep))

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of the kernel named ``kernel`` inside the window:
        the union of its launches' intervals, which overlap in a chain."""
        return self.busy_s(lambda name, cat: cat == "kernel" and base_name(name) == kernel)

    def kernel_count(self, kernel: str | None = None) -> int:
        return sum(1 for name, ts, dur, cat in self.device if cat == "kernel"
                   and (kernel is None or base_name(name) == kernel)
                   and self.window[0] <= ts < self.window[1])

    def kernel_roofline(self, kernel: str):
        """100 x the loop's bound over ``kernel``'s traced time, or None when
        the window ran no such kernel."""
        spent = self.kernel_s(kernel)
        if spent <= 0 or "loop_bytes" not in self.needed:
            return None
        from .roofline import bound_s
        bound = bound_s(self.needed["loop_bytes"], self.needed["loop_flops"], self.peaks)
        return 100.0 * bound / spent

    def mfu(self):
        if not self.device or not self.needed.get("flops") or self.window_s <= 0:
            return None
        return 100.0 * self.needed["flops"] / (self.window_s * self.peaks[1])

    def idle_pct(self):
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_ops(self, top: int = 10):
        """[[kernel name, seconds]] of the device operations that took most
        time in the window."""
        sums = {}
        for name, ts, dur, cat in self.device:
            if self.window[0] <= ts < self.window[1]:
                sums[name] = sums.get(name, 0.0) + dur / 1e6
        return [[n[:160], s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, longest: int = 1000):
        """[[host activity, seconds]]: the ``longest`` idle gaps of the
        device in the window, each named by the innermost host event that
        covers its middle, summed by name; the ``top`` names by seconds."""
        spans = sorted(self._inside())
        gaps, end = [], self.window[0]
        for t0, t1 in spans:
            if t0 > end:
                gaps.append((end, t0))
            end = max(end, t1)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        hosts = [h for h in self.host if h[0] != WINDOW]
        if hosts:
            h_ts = np.array([h[1] for h in hosts])
            h_end = h_ts + np.array([h[2] for h in hosts])
            h_dur = np.array([h[2] for h in hosts])
        sums = {}
        for g0, g1 in gaps:
            label = "host, no traced event"
            if hosts:
                mid = 0.5 * (g0 + g1)
                cover = np.nonzero((h_ts <= mid) & (h_end >= mid))[0]
                if cover.size:
                    label = hosts[int(cover[np.argmin(h_dur[cover])])][0]
            sums[label] = sums.get(label, 0.0) + (g1 - g0) / 1e6
        return [[n[:160], s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def read_chrome_trace(events, calls: int, needed: dict, peaks) -> Trace:
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, ts, dur, cat))
        elif cat in HOST_CATS:
            host.append((name, ts, dur, cat))
            if cat == "user_annotation" and name == WINDOW:
                window = (ts, ts + dur)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    return Trace(device, host, window, calls, needed, peaks)


def profile_calls(run_calls, calls: int, needed: dict, peaks, sync) -> Trace:
    """Trace ``run_calls(calls)`` (which makes the calls, each inside a
    ``portbench.call`` annotation) inside the window annotation, the card
    synchronised at both ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            run_calls(calls)
            sync()
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return read_chrome_trace(events, calls, needed, peaks)
