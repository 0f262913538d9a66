#!/usr/bin/env python3
"""Both packages' rate reports of the committed sw6 checkpoint
(``trained_weights/siam_overfit_full_sw6/ema_best.pkl``) on the CPU at
``scripts/codec_rate.py``'s defaults with the walk on: the script on
JAX-CPU as a subprocess, the port's ``rate_report`` with ``mptpu``'s noise
(event ``i`` draws ``uniform(fold_in(PRNGKey(42), i), (1, 1, 8192))``).

    python3 tests/reference/codec_rate_sw6.py

The script writes its report into ``--run``, so the checkpoint and the
run's ``metrics.json`` (whose config line sets the segment: seed 3, 12
events a window, 3 windows) are copied into a temporary directory first;
the port writes into another. Prints every number of both reports side by
side with their differences, and the largest difference by kind (SNR,
LSD, PIF). A few minutes and a few GiB.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from trajectory_common import ROOT, setup

RUN = ROOT / "trained_weights" / "siam_overfit_full_sw6"


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def main() -> int:
    setup()
    import jax
    import numpy as np
    import torch

    from mptpu_torch.models import codec_rate as cr

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        os.makedirs(run)
        for name in ("ema_best.pkl", "metrics.json"):
            shutil.copyfile(RUN / name, os.path.join(run, name))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "codec_rate.py"), "--run", run, "--walk"],
            cwd=str(ROOT), env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
            text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            return 1
        mptpu_s = time.perf_counter() - t0
        with open(os.path.join(run, "codec_rate.json")) as f:
            want = json.load(f)
        noise = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(42),
                                                                           i), (1, 1, 8192),
                                                        minval=-1.0, maxval=1.0))
                          for i in range(32)])
        t0 = time.perf_counter()
        got = cr.rate_report(run, os.path.join(tmp, "port"), walk=True,
                             noise=torch.from_numpy(noise), device="cpu", log=lambda s: None)
        port_s = time.perf_counter() - t0
    print(f"sw6 rate report at codec_rate.py's defaults, the walk on: mptpu {mptpu_s:.1f} s "
          f"(its process), port {port_s:.1f} s")
    worst = {"snr": 0.0, "lsd": 0.0, "pif": 0.0}
    for path, w in flat(want):
        g = dict(flat(got))[path]
        if isinstance(w, (bool, str)) or isinstance(w, int):
            print(f"  {path}: mptpu {w}  port {g}")
            continue
        diff = abs(g - w)
        kind = "lsd" if "lsd" in path else "pif" if "pif" in path else "snr" if path.endswith(
            "_db") else None
        if kind:
            worst[kind] = max(worst[kind], diff)
        print(f"  {path}: mptpu {w}  port {g:.6g}  diff {diff:.3g}")
    print(json.dumps({"largest_diff": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
