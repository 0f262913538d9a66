"""Readings that set a cell's limits, on the card, in one process.

    python -m portbench.calibrate --workload <name> [--seeds 12] [--control 3]
        [--faults 0] [--calls 4] [--first-seed N]

For each of ``--seeds`` seeds: the cell's set-up, ``--calls`` closed-loop
calls (at least the mix's checked calls), the sample checked as a run
checks it; the worst of each number, one JSON line a seed
(``"kind": "sound"``). Then the same with each of the entry's controls, the
plain reference in the program's place one precision below the
configuration's (``"kind": "control:<name>"``), on ``--control`` seeds,
and with each of its planted faults on ``--faults`` seeds. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def readings(spec, seed, calls, device, wrap=None) -> dict:
    import torch

    entry = spec.entry.Entry(spec.config, spec.traffic, seed, device, wrap=wrap)
    entry.warm()
    sampler = run.Sampler(spec.traffic["checked_calls"], seed)
    for i in range(max(calls, spec.traffic["checked_calls"])):
        out = entry.call(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sampler.offer(i, lambda: entry.keep(i, out))
    kept = entry.finish(sampler.kept)
    entry.release()
    t0 = time.perf_counter()
    records = entry.check(kept)
    worst = {}
    for rec in records:
        for name, value in rec.items():
            worst[name] = max(worst.get(name, float("-inf")), value)
    return dict(numbers={k: run.finite(v) for k, v in worst.items()},
                check_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=0)
    parser.add_argument("--calls", type=int, default=4)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    spec = run.load_spec(args.workload)
    plan = [("sound", None, args.seeds)]
    plan += [(f"control:{name}", wrap, args.control) for name, wrap in spec.entry.CONTROLS.items()]
    plan += [(f"fault:{name}", wrap, args.faults) for name, wrap in spec.entry.FAULTS.items()]
    seed = args.first_seed
    for kind, wrap, n in plan:
        for _ in range(n):
            seed += 1
            line = dict(workload=args.workload, kind=kind, seed=seed)
            line.update(readings(spec, seed, args.calls, device, wrap))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
