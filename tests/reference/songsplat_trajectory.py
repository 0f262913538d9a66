#!/usr/bin/env python3
"""The whole-song splat trainer's trajectory in ``mptpu`` (JAX on the CPU)
beside the port's (PyTorch on the CPU), from the same parameters, segments
and noise, at ``scripts/songsplat.py``'s ``--tiny`` size.

    python3 tests/reference/songsplat_trajectory.py [--steps 300]

Both start from ``mptpu``'s jitted init (``PRNGKey(0)``), carried into the
port by ``convert.songsplat_from_flax``; both train on the script's segment
stream (``default_rng(0)``) with step ``i``'s noise ``fold_in(key, i)``:
``mptpu`` by the script's jitted ``train_step`` (optax.adam(1e-3)), the port
by ``songsplat_step``. Every 100 steps it prints the loss summed
over the whole-song render's tiled segments, each with the render's noise
``fold_in(key, 100000 + start_frame)``, on both sides; at the start and the
end the render's covered SNR and LSD (``song_eval.json``'s, no refit) on
both sides; at the end the means
of every 25 steps' own losses on both sides, and the seconds each
side took. Imports both packages; needs no card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch

    from mptpu.models.songsplat import SongSplatModel as JModel
    from mptpu_torch import convert
    from mptpu_torch.models import songsplat as tss
    from mptpu_torch.train.optim import Adam

    spec = importlib.util.spec_from_file_location("songsplat", ROOT / "scripts" / "songsplat.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    torch.set_num_threads(2)

    total, seg, eps, cap = tss.TINY
    key = jax.random.PRNGKey(0)
    jm = JModel(total_samples=total, n_segment_samples=seg, events_per_second=eps,
                events_per_segment=cap)
    params = jax.jit(jm.init)(key, jnp.array(jm.segment_frames), key)
    tm = convert.songsplat_from_flax(
        tss.SongSplatModel(total, seg, events_per_second=eps, events_per_segment=cap,
                           device="cpu"), params)
    song = script.get_song(None, total, jm.samplerate)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    adam = Adam(1e-3)
    t_state = adam.init(list(tm.parameters()))
    stream = script.segment_stream(song, jm)

    def j_loss(p, target, start_frame, k):   # scripts/songsplat.py:loss_fn
        rendered, _, _, _ = jm.apply(p, start_frame, k)
        recon = jnp.sum(rendered, axis=1, keepdims=True)
        return jnp.abs(script.spec_transform(recon) - script.spec_transform(target)).sum()

    @jax.jit
    def train_step(p, s, target, start_frame, k):   # scripts/songsplat.py:train_step
        loss, grads = jax.value_and_grad(j_loss)(p, target, start_frame, k)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    def noise(k):
        return torch.from_numpy(np.array(jax.random.uniform(k, (1, 1, 2 * seg), minval=-1.0,
                                                            maxval=1.0)))

    f = jm.segment_frames
    frames = list(range(f, jm.total_frames - f, f))
    j_eval = jax.jit(j_loss)

    def fixed():
        """The loss summed over the render's segments: mptpu's, the port's."""
        j_sum = t_sum = 0.0
        for sf in frames:
            k = jax.random.fold_in(key, 100000 + sf)
            target = song[sf * jm.step_size: sf * jm.step_size + seg].reshape(1, 1, -1)
            j_sum += float(j_eval(params, jnp.asarray(target), jnp.array(sf), k))
            with torch.no_grad():
                t_sum += float(tss.songsplat_loss(tm, torch.from_numpy(target), sf, noise(k))[0])
        return j_sum, t_sum

    apply = jax.jit(jm.apply)

    def covered():
        """The whole-song render's covered SNR and LSD (scripts/songsplat.py,
        no refit): mptpu's, the port's."""
        recon = np.zeros(total, np.float32)
        for sf in frames:
            rendered = apply(params, jnp.array(sf), jax.random.fold_in(key, 100000 + sf))[0]
            out = np.asarray(jnp.sum(rendered, axis=1)[0]).reshape(-1)
            recon[sf * jm.step_size: sf * jm.step_size + len(out)] = out
        lo, hi = f * jm.step_size, (jm.total_frames - f) * jm.step_size
        t_cov, r_cov = song[lo:hi], recon[lo:hi]
        snr = 10 * np.log10((np.sum(t_cov**2) + 1e-12) / (np.sum((t_cov - r_cov) ** 2) + 1e-12))
        ts = jnp.abs(script.spec_transform(jnp.asarray(t_cov).reshape(1, 1, -1)))
        rs = jnp.abs(script.spec_transform(jnp.asarray(r_cov).reshape(1, 1, -1)))
        lsd = float(jnp.sqrt(jnp.mean((20 * jnp.log10(ts + 1e-8) - 20 * jnp.log10(rs + 1e-8))
                                      ** 2)))
        _, mine = tss.render_song(tm, song, 0.0, device="cpu",
                                  noise=lambda sf: noise(jax.random.fold_in(key, 100000 + sf)))
        return (f"covered SNR {snr:.3f} / {mine['covered_snr_db']:.3f} dB, LSD {lsd:.3f} / "
                f"{mine['covered_lsd_db']:.3f} dB")

    print(f"--tiny: {total} samples, segments of {seg}, {jm.total_events} events, capacity "
          f"{cap}; the loss over the render's {len(frames)} segments (mptpu, port):")
    print(f"step 0: {fixed()}; the render (mptpu / port): {covered()}")
    j_losses, t_losses, j_s, t_s = [], [], 0.0, 0.0
    for i in range(args.steps):
        target, start_frame = next(stream)
        k = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, target, jnp.array(start_frame), k)
        j_losses.append(float(loss))
        j_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, _, _, t_state = tss.songsplat_step(tm, adam, t_state, torch.from_numpy(
            np.array(target)), start_frame, noise(k))
        t_losses.append(float(loss))
        t_s += time.perf_counter() - t0
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}: {fixed()}", flush=True)
    print(f"step {args.steps}: the render (mptpu / port): {covered()}")
    w = 25
    for name, losses in (("mptpu", j_losses), ("port ", t_losses)):
        print(f"{name}: the means of every {w} steps' own losses "
              + ", ".join(f"{np.mean(losses[s: s + w]):.1f}" for s in range(0, len(losses), w)))
    print(f"seconds: mptpu {j_s:.1f}, port {t_s:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
