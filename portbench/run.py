"""Run one cell of the benchmark once.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name: ``BENCHMARK.json``'s ``workloads`` entry names the
configuration (its ``file``) and the mix (``portbench/traffic/<mix>.json``),
whose ``entry`` names the module under ``portbench/entries/`` that drives
the program; the limits of the correctness check are in
``portbench/limits/<cell>.json``, each end-to-end metric's reader in
``portbench/e2e/<metric>.py`` and each per-layer metric's in
``portbench/metrics/<metric>.py``, or, where a metric named
``<prefix>.<reader>`` has no file of its own, in the shared
``portbench/metrics/<reader>.py``.

With ``--trace 0`` the run sets up, then calls the program in a closed loop
(the next call when the last has returned and the card is synchronised)
for ``--seconds`` seconds, and prints the cell's end-to-end metrics. With
``--trace 1`` it traces the traffic mix's ``traced_calls`` calls instead
and prints the per-layer metrics. Either way, once the calls are done, the
peak memory read and the program's state freed, the plain reference checks
a seeded sample of the calls' outputs, each number against its limit. The
last line of standard output is the result as JSON.
"""

from __future__ import annotations

import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

from .roofline import device_peaks  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that must not be loaded: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "mptpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), 0 elsewhere."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T_IMPORT - process_age_s()


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def module_at(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(metric: str) -> Path:
    """The reader of the per-layer metric ``metric``: its own file, or the
    shared reader named by what follows its first dot."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.is_file() or "." not in metric else \
        HERE / "metrics" / f"{metric.split('.', 1)[1]}.py"


@dataclass
class Spec:
    """One cell and everything the run needs of it, found by name."""

    bench: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    entry: object = field(repr=False)

    @property
    def name(self) -> str:
        return self.cell["name"]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in reported else [])]


def load_spec(workload: str, root: Path = CHECKOUT) -> Spec:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / config_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    return Spec(bench, cell, config, traffic, limits, entry)


@dataclass
class Window:
    """What the closed loop did: ``seconds`` from the first call's start to
    the last call's end, the calls, the work they completed and each call's
    latency in seconds; and the set-up before it."""

    seconds: float
    calls: int
    work: int
    latencies: list
    setup_s: float


class Sampler:
    """A uniform sample of ``size`` calls out of however many the run makes,
    drawn from the seed (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept = size, random.Random(f"portbench/{seed}"), []

    def offer(self, i: int, keep):
        if i < self.size:
            self.kept.append(keep())
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.kept[j] = keep()


def closed_loop(entry, seconds: float, sampler: Sampler, sync, setup_s: float) -> Window:
    latencies, i = [], 0
    sync()
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        out = entry.call(i)
        sync()
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        sampler.offer(i, lambda: entry.keep(i, out))
        del out
        i += 1
        if c1 - t0 >= seconds:
            break
    return Window(c1 - t0, i, i * entry.work_per_call, latencies, setup_s)


def traced(entry, spec: Spec, sampler: Sampler, sync, peaks):
    """Trace the mix's ``traced_calls`` calls; where the trace's launches of
    the program's loop kernels differ from the program's own counters, say
    so and trace a stretch half as long, up to three times."""
    from torch.profiler import record_function

    from mptpu_torch.kernels import LAUNCHES as counters

    from . import tracing

    made = [0]

    def run_calls(k):
        for _ in range(k):
            i = made[0]
            with record_function(tracing.CALL):
                out = entry.call(i)
                sync()
            sampler.offer(i, lambda: entry.keep(i, out))
            del out
            made[0] += 1

    calls = spec.traffic["traced_calls"]
    for _ in range(3):
        before = dict(counters)
        trace = tracing.profile_calls(run_calls, calls, entry.needed(calls), peaks, sync)
        mismatch = {k: (trace.kernel_count(k), counters[c] - before[c])
                    for k, c in tracing.LOOP_KERNELS.items()
                    if trace.kernel_count(k) != counters[c] - before[c]}
        if not mismatch:
            return trace, made[0]
        print(f"trace of {calls} calls: launches in the trace against the program's counters "
              f"{mismatch}; tracing {max(1, calls // 2)} calls", file=sys.stderr)
        calls = max(1, calls // 2)
    return trace, made[0]


def card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def finite(x: float) -> float:
    """JSON has no infinity: a number that is not finite prints as 1e308."""
    return x if math.isfinite(x) else 1e308


def judge(records: list, limits: dict):
    """(correct, failed, {number: (worst value, limit)}): every checked
    call's every number at or under its limit, and something checked."""
    worst = {}
    failed = 0
    for rec in records:
        bad = False
        for name, value in rec.items():
            limit = limits.get(name, -math.inf)
            worst[name] = max(worst.get(name, -math.inf), value)
            bad |= not value <= limit
        failed += bad
    compared = {name: (worst[name], limits.get(name, -math.inf)) for name in worst}
    correct = bool(records) and failed == 0 and set(worst) == set(limits)
    return correct, failed, compared


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in BANNED})


def execute(spec: Spec, seed: int, seconds: float, trace: bool, device, wrap=None) -> dict:
    """The run as the command makes it, on ``device``, with the program's
    callable passed through ``wrap`` where given; returns the result."""
    import torch

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t_inputs = time.monotonic()
    entry = spec.entry.Entry(spec.config, spec.traffic, seed, device, wrap=wrap)
    sync()
    t_warm = time.monotonic()
    entry.warm()
    sync()
    setup_s = time.monotonic() - T_START
    print(f"set-up {setup_s:.3f} s: start to inputs {t_inputs - T_START:.3f} s (imports), "
          f"inputs {t_warm - t_inputs:.3f} s (the CUDA context with them), "
          f"warm-up {T_START + setup_s - t_warm:.3f} s", file=sys.stderr)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    sampler = Sampler(spec.traffic["checked_calls"], seed)
    kind = card_name() if on_card else "cpu"
    peaks = device_peaks(kind) if on_card else None
    if trace:
        tr, calls = traced(entry, spec, sampler, sync, peaks)
    else:
        window = closed_loop(entry, seconds, sampler, sync, setup_s)
        calls = window.calls
        lat = sorted(window.latencies)
        print(f"window {window.seconds:.3f} s, {calls} calls; latency ms min "
              f"{lat[0] * 1e3:.3f}, median {lat[len(lat) // 2] * 1e3:.3f}, max "
              f"{lat[-1] * 1e3:.3f}", file=sys.stderr)
    sync()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    metrics = {}
    if trace:
        for m in spec.per_layer():
            value = module_at("metrics", reader_path(m["name"]).stem).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end():
            value = module_at("e2e", m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    kept = entry.finish(sampler.kept)
    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    records = entry.check(kept)
    print(f"checked {len(records)} call(s) against the reference in "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    correct, failed, compared = judge(records, spec.limits)

    result = {"correct": correct, "attempted": calls, "failed": failed, "metrics": metrics}
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                        "count": spec.cell["chips"], "memory_peak_bytes": memory_peak}
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s,
                                power_limit=power_limit() if on_card else "cpu")
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": finite(v), "limit": finite(lim)}
                        for name, (v, lim) in compared.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
        print(f"{args.workload} needs {spec.cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = execute(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    found = banned_modules()
    if found:
        print(f"loaded in this process: {found} (JAX or the JAX package)", file=sys.stderr)
        return 3
    if args.trace:
        print(f"shares against {result['device']['kind']}'s data-sheet peaks; nvidia-smi: "
              f"{result['device']['power_limit']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
