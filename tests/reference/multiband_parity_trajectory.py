#!/usr/bin/env python3
"""``mptpu``'s multiband learning trajectory at ``scripts/multiband_parity.py``'s
configuration (``e_2024_4_24``: 7 bands from 512 to 32,768 samples, 512
atoms x 128 taps, 64 steps a band, batch 2 of ``synthetic_audio(2**15,
seed=100 + i)``, dictionaries from ``np.random.default_rng(99)``), on
JAX-CPU: the reconstruction SNR before learning and after each of the
first ``--iterations`` learning iterations (default 3), the figures
``chip_smoke.MULTIBAND_PARITY_REFERENCE`` holds the card to (recorded as
``ours_snr_db`` in ``trained_weights/multiband_parity.json``, printed
beside them). With ``--port`` the port's ``parity_trajectory`` runs beside
it on the CPU, from the same dictionaries and batch. ``--small`` runs the
rehearsal's configuration (``chip_smoke.SCRIPTS_SMALL``: 3 bands of 16
atoms x 32 taps on 2,048 samples, 8 steps, 2 iterations), whose figures
are ``chip_smoke.MULTIBAND_PARITY_SMALL``.

    python3 tests/reference/multiband_parity_trajectory.py [--iterations 3] [--port] [--small]

About a minute for the JAX side and under 1 GiB.
"""

from __future__ import annotations

import argparse
import json
import time

from trajectory_common import ROOT, setup


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    setup()
    import jax.numpy as jnp
    import numpy as np

    from mptpu.ops.norms import unit_norm
    from mptpu.sparse import BandSpec, MultibandDictionaryLearning
    from mptpu_torch.models import multiband_parity as mbp

    small = dict(n_samples=2048, n_atoms=16, atom_size=32, steps=8, sizes=(512, 1024, 2048))
    c = dict(mbp.CONFIG, **(small if args.small else {}))
    n, steps = c["n_samples"], c["steps"]
    init = mbp.initial_dictionaries(c["n_atoms"], c["atom_size"], c["sizes"])
    batch = jnp.asarray(mbp.parity_batch(n, c["batch_size"]))
    model = MultibandDictionaryLearning(
        [BandSpec(s, c["n_atoms"], c["atom_size"], signal_samples=n,
                  is_lowest_band=(s == c["sizes"][0]), d=unit_norm(jnp.asarray(init[s])))
         for s in c["sizes"]], n_samples=n)

    def snr():
        recon, _ = model.recon(batch, steps)
        num = float(jnp.sum(batch**2))
        den = float(jnp.sum((batch - recon) ** 2))
        return 10.0 * np.log10(num / max(den, 1e-12))

    rows = []
    for it in range(args.iterations + 1):
        t0 = time.perf_counter()
        if it:
            model.learn(batch, steps)
        learn_s = time.perf_counter() - t0 if it else 0.0
        rows.append(dict(iteration=it, mptpu_snr_db=snr(), mptpu_learn_s=learn_s))
        print(json.dumps(rows[-1]), flush=True)
    if not args.small:
        recorded = json.loads((ROOT / "trained_weights" / "multiband_parity.json").read_text())
        print("recorded ours_snr_db:", [r["ours_snr_db"] for r in recorded["rows"]
                                        ][: args.iterations + 1])
    print("mptpu, rounded to 3:", [round(r["mptpu_snr_db"], 3) for r in rows])
    if args.port:
        port = mbp.parity_trajectory(args.iterations, device="cpu", reference=None,
                                     log=lambda s: None, **(small if args.small else {}))
        for r, p in zip(rows, port["rows"]):
            print(f"iteration {r['iteration']}: mptpu {r['mptpu_snr_db']:.4f} dB, port "
                  f"{p['ours_snr_db']:.4f} dB ({p['ours_snr_db'] - r['mptpu_snr_db']:+.2e}), "
                  f"learn {p['ours_learn_s']:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
