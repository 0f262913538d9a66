#!/usr/bin/env python3
"""The functional song trainer's trajectory in ``mptpu`` (JAX on the CPU)
beside the port's (PyTorch on the CPU), from the same parameters and
batches: the port's seed-0 ``FuncSong`` carried into ``mptpu`` by
``convert.module_to_flax``, at ``scripts/funcsong.py``'s defaults (the
30 s synthetic song, crops of 2^15, batch 4, 256 position channels,
hidden 256, 4 layers, 64 resonances, lr 1e-3), the crops' starts from
``np.random.default_rng(0)``.

    python3 tests/reference/funcsong_trajectory.py [--steps 10] [--smoke]

The model is chaotic in its parameters. Its oscillator phases reach 3e5
rad, and a phase moves by about 3.5e5 rad per unit of tension, so one
float64 place of a tension moves the loss's gradients by some 1e-3 of
their largest (printed below). Adam's first steps are about ``lr`` times
the gradient's sign, so any two implementations, in float32 or float64,
part after the first step: no trajectory can be held to another step by
step. What they share is how the loss moves against the untrained
model's. So this prints four sound runs, ``mptpu``'s and the port's, each
in float32 (the script's) and float64 (``jax_enable_x64``), and a frozen
control, the seed-0 model's loss on each step's crops with no update;
each beside ``mptpu``'s float32 trajectory, as the largest gap over its
largest loss, and its rise over the control: the median over the last
half of the steps of its loss over the control's, less 1. A gate on that
trajectory must pass the sound runs and fail the control.

The position encoding is ill-conditioned in float32 at this song's
length (``song_pos_encoding``'s arguments reach 2e6 rad), so every run
takes the port's: ``crop_batch``'s float32 crops and encodings (cast to
float64 for the float64 runs). ``mptpu`` steps by the script's jitted step
(``scripts/funcsong.py:114-127``) on those batches, the port in float32 by
its entry point ``train_funcsong``, in float64 by its loop. Also prints the first step's float64 gradients
of the two packages against each other, and the port's against itself
with every tension moved by one float64 place.

About 10 minutes and 11 GiB at the defaults (20 and 11 at ``--steps 20``).
"""

from __future__ import annotations

import argparse
import json
import time

from trajectory_common import flax_params, setup


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--smoke", action="store_true")
    args = parser.parse_args()
    setup()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from mptpu.models.funcsong import FuncSong as JFuncSong
    from mptpu.ops.stft import stft as j_stft
    from mptpu_torch import convert
    from mptpu_torch.models import funcsong as tfs
    from mptpu_torch.train.optim import Adam

    jax.config.update("jax_enable_x64", True)
    n, c, hidden, layers, batch = 2**15, 256, 256, 4, 4
    if args.smoke:
        s = tfs.SMOKE
        n, c, hidden, layers, batch = (s["segment_samples"], s["pos_channels"], s["hidden"],
                                       s["layers"], s["batch_size"])
    song = tfs.funcsong_song()
    total = len(song)
    song_t = torch.from_numpy(song)

    def seeded():
        return tfs.FuncSong(n, c, hidden, layers, generator=torch.Generator().manual_seed(0),
                            device="cpu")

    jm = JFuncSong(segment_size=n, in_channels=c, hidden_channels=hidden, n_layers=layers)
    init = flax_params(seeded())
    opt = optax.adam(1e-3)

    def loss_fn(p, target, pos):
        recon = jm.apply(p, pos)
        return jnp.sum(jnp.abs(j_stft(recon, 2048, 256, pad=True)
                               - j_stft(target, 2048, 256, pad=True)))

    @jax.jit
    def train_step(p, st, target, pos):
        loss, grads = jax.value_and_grad(loss_fn)(p, target, pos)
        updates, st = opt.update(grads, st, p)
        return optax.apply_updates(p, updates), st, loss

    rng = np.random.default_rng(0)
    batches = [tfs.crop_batch(song_t, torch.from_numpy(rng.integers(0, total - n, size=batch)),
                              n, c) for _ in range(args.steps)]

    def mptpu_run(dtype):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), init)
        state, losses = opt.init(params), []
        for target, pos in batches:
            params, state, loss = train_step(params, state, jnp.asarray(target.numpy(), dtype),
                                             jnp.asarray(pos.numpy(), dtype))
            losses.append(float(loss))
        return losses

    def port_run(dtype):
        if dtype == torch.float32:   # the entry point, as the card runs it
            return tfs.train_funcsong(iterations=args.steps, smoke=args.smoke, out=None,
                                      device="cpu", log=lambda s: None).losses
        model = seeded().to(dtype)
        adam = Adam(1e-3)
        state, losses = adam.init(list(model.parameters())), []
        for target, pos in batches:   # train_funcsong's loop
            loss, _, state = tfs.funcsong_step(model, adam, state, target.to(dtype),
                                               pos.to(dtype))
            losses.append(float(loss))
        return losses

    runs, seconds = {}, {}
    for name, fn in (("mptpu float32", lambda: mptpu_run(jnp.float32)),
                     ("mptpu float64", lambda: mptpu_run(jnp.float64)),
                     ("port float32", lambda: port_run(torch.float32)),
                     ("port float64", lambda: port_run(torch.float64))):
        t0 = time.perf_counter()
        runs[name] = fn()
        seconds[name] = time.perf_counter() - t0
    frozen = seeded()
    with torch.no_grad():
        runs["frozen control"] = [float(tfs.funcsong_loss(frozen, t, p)[0]) for t, p in batches]

    ref = np.asarray(runs["mptpu float32"])
    scale = np.abs(ref).max()
    control = np.asarray(runs["frozen control"])
    half = len(ref) // 2
    q = max(3, len(ref) // 4)
    print(f"funcsong{' smoke' if args.smoke else ''}: {args.steps} steps; the gap is each "
          f"step's distance from mptpu's float32 trajectory over its largest loss {scale:.7g}")
    for name, losses in runs.items():
        v = np.asarray(losses)
        gaps = np.abs(v - ref) / scale
        print(f"  {name}" + (f" ({seconds[name]:.1f} s)" if name in seconds else "")
              + ": loss " + ", ".join(f"{x:.7g}" for x in v)
              + f"; gap every step " + ", ".join(f"{g:.2e}" for g in gaps)
              + f"; largest {gaps.max():.3e}; medians of the first and last {q}: "
              f"{np.median(v[:q]):.7g} -> {np.median(v[-q:]):.7g}; rise over the control "
              f"(chip_smoke.rise_over) {np.median(v[half:] / control[half:]) - 1:.4f}")

    def port_grads(tension_nudge=False):
        m = seeded().double()
        if tension_nudge:
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for name, p in m.named_parameters():
                    if name.endswith("tension"):
                        sign = torch.randint(0, 2, p.shape, generator=g).double() * 2 - 1
                        p.mul_(1 + sign * 2.0**-52)
        names, ps = zip(*m.named_parameters())
        loss = tfs.funcsong_loss(m, batches[0][0].double(), batches[0][1].double())[0]
        return dict(zip(names, torch.autograd.grad(loss, ps)))

    def leaf_errs(a, b):
        return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b}

    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), init)
    j_grads = jax.jit(jax.grad(loss_fn))(p64, *(jnp.asarray(b.numpy(), jnp.float64)
                                                for b in batches[0]))["params"]
    jg = {}
    for name, path in convert.flax_paths(seeded()).items():
        leaf = j_grads
        for k in path:
            leaf = leaf[k]
        arr = torch.from_numpy(np.array(leaf))
        jg[name] = arr.T if path[-1] == "kernel" else arr
    g = port_grads()
    for label, e in (("mptpu's against the port's", leaf_errs(jg, g)),
                     ("the port's with each tension one place off, against the port's",
                      leaf_errs(port_grads(tension_nudge=True), g))):
        worst = max(e, key=e.get)
        print(f"first step, float64 gradients, {label}: largest {e[worst]:.3e} of the leaf's "
              f"largest ({worst}); median over the leaves {np.median(list(e.values())):.3e}")
    print(json.dumps({"model": "funcsong" + (" smoke" if args.smoke else ""),
                      "mptpu": [float(f"{v:.6g}") for v in ref],
                      "control": [float(f"{v:.6g}") for v in control]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
