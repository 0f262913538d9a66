#!/usr/bin/env python3
"""How far the scattering texture loss's float32 gradient is from float64
on the CPU, at ``chip_smoke.py``'s phase-12 start.

    python3 tools/scattering_precision.py [--log2-samples 17]

On phase 12(c)'s target (``synthetic_audio(n, 22050, seed=5)``, max-normed)
and start (0.01 x a standard normal draw from a CPU generator seeded with
0), it computes ``synthesize_texture``'s first loss and its gradient by the
waveform with ``features="scattering"`` (64 gammatone filters of 128 taps)
on the CPU in float32 and in float64, and prints the float32 gradient's
largest error over the float64 gradient's largest, the two losses, each
pass's seconds and the process's peak resident memory.
That error is the float32 rounding that phase 12 sets its card-against-CPU
float32 gradient gate from. Needs no card; at 2^17 samples the float64 pass
holds several (64, 64, 2^17) tensors, about 20 GiB.
"""

from __future__ import annotations

import argparse
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log2-samples", type=int, default=17)
    args = parser.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.ops.norms import max_norm

    n = 2**args.log2_samples
    cpu = torch.device("cpu")
    target = max_norm(torch.from_numpy(synthetic_audio(
        n, 22050, n_events=max(4, int(n / 22050 * 8)), seed=5)).reshape(1, 1, -1))
    init = torch.randn((1, 1, n), generator=torch.Generator().manual_seed(0)) * 0.01
    out = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        out[dtype] = chip_smoke.texture_gradient("scattering", n, False, init, target, cpu,
                                                 dtype)
        print(f"{dtype}: loss {out[dtype][0]:.9g}, {time.perf_counter() - t0:.1f} s")
    (l32, g32), (l64, g64) = out[torch.float32], out[torch.float64]
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"scattering at {n} samples, 64 filters, on the CPU ({torch.get_num_threads()} "
          f"threads): float32 gradient {chip_smoke.share_err(g32, g64):.3e} of the float64 one's "
          f"largest off it; loss {abs(l32 - l64) / abs(l64):.3e} of it off; peak resident memory "
          f"{peak:.2f} GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
