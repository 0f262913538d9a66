"""Mass-spring ("goo") physical simulation (counterpart of
``mptpu/gen/goo.py``): point masses joined by damped springs, integrated
by semi-implicit Euler, excited by forces and read at a pickup mass.

``mptpu`` rolls the simulation out as one ``lax.scan``; here it is a
Python loop over steps on device tensors, each spring's force added to
both its masses by ``index_add`` (a string has no mass twice in one add,
so the sums are exact on a card too). The arithmetic runs in the forces'
dtype: over 2^15 steps of a lightly damped string float32 rounding grows,
so comparisons across packages or devices hold it in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import default_device


class SpringMesh(NamedTuple):
    positions: torch.Tensor     # (n_masses, dims) rest positions
    springs: torch.Tensor       # (n_springs, 2) int64 endpoint indices
    rest_lengths: torch.Tensor  # (n_springs,)
    stiffness: torch.Tensor     # (n_springs,)
    damping: torch.Tensor       # (n_masses,) velocity damping
    fixed: torch.Tensor         # (n_masses,) 1.0 where immovable


def string_mesh(n_masses: int = 32, stiffness: float = 80.0, damping: float = 0.999,
                fixed_ends: bool = True, dtype=torch.float32, device=None) -> SpringMesh:
    """A 1-d string of masses (the plucked-string setup): the numbers are
    ``mptpu``'s float32 ones, then cast to ``dtype``, on
    ``default_device(device)``."""
    pos = np.zeros((n_masses, 1), dtype=np.float32)
    pos[:, 0] = np.linspace(0, 1, n_masses)
    springs = np.stack([np.arange(n_masses - 1), np.arange(1, n_masses)], axis=1)
    rest = np.full((n_masses - 1,), 1.0 / (n_masses - 1), dtype=np.float32)
    stiff = np.full((n_masses - 1,), stiffness, dtype=np.float32)
    damp = np.full((n_masses,), damping, dtype=np.float32)
    fixed = np.zeros((n_masses,), dtype=np.float32)
    if fixed_ends:
        fixed[0] = fixed[-1] = 1.0
    dev = default_device(device)
    f = lambda a: torch.from_numpy(a).to(dev, dtype)   # noqa: E731
    return SpringMesh(f(pos), torch.from_numpy(springs).to(dev), f(rest), f(stiff), f(damp),
                      f(fixed))


def simulate(mesh: SpringMesh, forces: torch.Tensor, pickup: int = 1,
             dt: float = 1.0 / 22050.0) -> torch.Tensor:
    """Roll the simulation out under ``forces`` (n_steps, n_masses) of
    transverse forcing; returns the pickup mass's transverse displacement
    (n_steps,). Differentiable in the forces and the mesh's numbers."""
    n_masses = mesh.positions.shape[0]
    i, j = mesh.springs[:, 0], mesh.springs[:, 1]
    movable = 1.0 - mesh.fixed
    disp = forces.new_zeros(n_masses)
    vel = forces.new_zeros(n_masses)
    out = []
    for force in forces.unbind(0):
        f_spring = mesh.stiffness * (disp[j] - disp[i])   # linearised transverse spring force
        accel = disp.new_zeros(n_masses).index_add(0, i, f_spring).index_add(0, j, -f_spring)
        accel = accel + force
        vel = (vel + accel * dt * 1000.0) * mesh.damping * movable
        disp = (disp + vel * dt * 1000.0) * movable
        out.append(disp[pickup])
    return torch.stack(out)


def pluck_forces(n_steps: int, n_masses: int, position: int, width: int = 3,
                 amplitude: float = 1.0, attack: int = 16, device=None) -> torch.Tensor:
    """An impulsive pluck: a rising half Hann window over the first
    ``attack`` steps on the masses within ``width`` of ``position``,
    (n_steps, n_masses) float32 on ``default_device(device)``."""
    forces = np.zeros((n_steps, n_masses), dtype=np.float32)
    lo = max(0, position - width)
    hi = min(n_masses, position + width + 1)
    env = np.hanning(attack * 2)[:attack]
    forces[:attack, lo:hi] = amplitude * env[:, None]
    return torch.from_numpy(forces).to(default_device(device))
