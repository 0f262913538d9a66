"""Shared by the ``*_trajectory.py`` scripts: the JAX setup on the CPU, the
port's seeded model carried into ``mptpu``, and the printout of two loss
trajectories side by side. Imports both packages; needs no card."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def setup():
    """Both packages importable, JAX on the CPU, PyTorch on two threads."""
    sys.path.insert(0, str(ROOT))
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)


def flax_params(module):
    """The port's module as ``mptpu``'s flax variables (jnp arrays)."""
    import jax.numpy as jnp

    from mptpu_torch import convert

    tree = convert.module_to_flax(module)
    return {"params": _to_jnp(tree["params"], jnp)}


def _to_jnp(tree, jnp):
    return {k: _to_jnp(v, jnp) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def report(name: str, mptpu_losses, port_losses, seconds) -> None:
    """Both trajectories, each step's gap over mptpu's largest loss, the
    medians of the first and last quarter, and one JSON line of mptpu's
    losses (what chip_smoke.py holds the card to)."""
    m, p = np.asarray(mptpu_losses, np.float64), np.asarray(port_losses, np.float64)
    scale = max(np.abs(m).max(), 1e-30)
    gaps = np.abs(m - p) / scale
    q = max(3, len(m) // 4)
    print(f"{name}: {len(m)} steps; mptpu {seconds[0]:.1f} s, port {seconds[1]:.1f} s")
    for i, (a, b, g) in enumerate(zip(m, p, gaps)):
        print(f"  step {i}: mptpu {a:.7g}  port {b:.7g}  gap {g:.2e} of mptpu's largest")
    print(f"  largest gap {gaps.max():.3e}; medians of the first and last {q}: mptpu "
          f"{np.median(m[:q]):.7g} -> {np.median(m[-q:]):.7g}, port {np.median(p[:q]):.7g} -> "
          f"{np.median(p[-q:]):.7g}")
    print(json.dumps({"model": name, "mptpu": [float(f"{v:.6g}") for v in m],
                      "largest_gap": float(f"{gaps.max():.3e}")}))
