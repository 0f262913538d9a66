#!/usr/bin/env python3
"""The room overfit's trajectory in ``mptpu`` (JAX on the CPU) beside the
port's (PyTorch on the CPU), from the same parameters: the port's seed-0
``RoomModel`` carried into ``mptpu`` by ``convert.module_to_flax``, fitted
to ``scripts/roomsim.py``'s recording (block 64, 512 frames, the 5 x 17 x
9 room, over its peak) by a 5 x 5 room at lr 1e-2, as
``scripts/roomsim.py --overfit-steps`` fits it.

    python3 tests/reference/roomsim_trajectory.py [--steps 20] [--small]

``--small`` takes chip_smoke.py's rehearsal size (block 16, 32 frames, a
5 x 5 x 5 room, fitted by a 3 x 3 room).

``mptpu`` simulates and steps by the script's jitted functions
(``scripts/roomsim.py:72-101``), the port by ``simulate_room`` and
``overfit_room``'s step. Prints both losses a step and a JSON line of
``mptpu``'s (``chip_smoke.LONGTAIL_REFERENCE``). About a minute.
"""

from __future__ import annotations

import argparse
import importlib
import time

from trajectory_common import flax_params, report, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--small", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from mptpu.gen.roomsim import RoomModel as JRoomModel, roomsim as j_roomsim

    troom = importlib.import_module("mptpu_torch.gen.roomsim")
    block, frames, room = (16, 32, 3) if args.small else (64, 512, 5)
    size = dict(block_size=block, n_frames=frames, width=5, height=5 if args.small else 17,
                depth=5 if args.small else 9)
    transfer, control = troom.room_inputs(**size)
    rec, _ = jax.jit(j_roomsim)(jnp.asarray(transfer, jnp.float32), jnp.asarray(control))
    rec = np.asarray(rec)
    target = jnp.asarray(rec / (np.abs(rec).max() + 1e-9)).reshape(1, 1, -1)
    sim = troom.simulate_room(**size, device="cpu", log=lambda s: None)
    port_rec = sim.recording.numpy()
    t_target = torch.from_numpy(port_rec / (np.abs(port_rec).max() + 1e-9)).reshape(1, 1, -1)
    print(f"recording: the port's {np.abs(port_rec - rec).max() / np.abs(rec).max():.2e} of the "
          f"peak from mptpu's")

    tm = troom.RoomModel(room, block, frames, torch.Generator().manual_seed(0), device="cpu")
    jm = JRoomModel(room_size=room, voxel_size=block, n_frames=frames)
    params = flax_params(tm)
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(lambda q: jnp.mean((jm.apply(q) - target) ** 2))(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    t0 = time.perf_counter()
    state, jl = opt.init(params), []
    for _ in range(args.steps):
        params, state, loss = step(params, state)
        jl.append(float(loss))
    t1 = time.perf_counter()
    fit = troom.overfit_room(t_target, room, block, frames, steps=args.steps, device="cpu",
                             log=lambda s: None)
    report("roomsim overfit" + (" small" if args.small else ""), jl, fit.losses,
           (t1 - t0, time.perf_counter() - t1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
