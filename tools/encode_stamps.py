#!/usr/bin/env python3
"""Where the whole-encode kernels spend a step, on a CUDA card.

    python3 tools/encode_stamps.py [--clusters 2 8] [--stages 0 16] [--variants]

Builds stamped copies of ``mptpu_torch/csrc`` into ``build/encode_stamps/``:
in each step of ``enc::encode_body`` the first thread of a block reads
``clock64()`` at the ends of the select (cluster barrier included), the
surgery (tail product included), its own warp's window pass and the rest
of the step, and the first thread of the last warp its own window pass;
each block adds its sums to a device array once, at its end. It then runs
the whole-encode kernel (K2, ``mp_fused_encode``) and the lane-table encode
(K5, ``mp_fused_encode_lane``) on the bench encode's state
(``chip_smoke.py``'s inputs: 32 items, 512 atoms x 512 taps, 16,384
samples, 100 steps, block 128) at each cluster size and ring depth asked
for (as many stages as fit where fewer do; ``--stages 0``: the plan's
own), and prints the encode's time (CUDA events behind a device spin) and
the cycles per block and step of each phase. With ``--variants``, K5 also runs in copies without parts of its
lane work, which attribute its time: without the lane's reduction in the
window pass (its lanes and so its events then differ), without its
lane-table stores, and without the lane read after a row's rescan.

The stamps cost time themselves: compare the copies with each other, not
with ``chip_smoke.py``'s times. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "encode_stamps"

# (anchor in mp_window.cuh, its replacement)
STAMPS = [
    ("#include <climits>\n", "#include <climits>\n#include <cstdlib>\n"),
    ("namespace enc {\n", "namespace enc {\nstatic __device__ unsigned long long g_stamps[8];\n"),
    ("  uint32_t phases = 0;", "  long long acc[5] = {0, 0, 0, 0, 0};\n  uint32_t phases = 0;"),
    ("  for (int step = 0; step < (kStep ? 1 : n_steps); ++step) {\n",
     "  for (int step = 0; step < (kStep ? 1 : n_steps); ++step) {\n    long long t0 = clock64();\n"),
    ("    // the ring's first fills need only the winner: start them now\n",
     "    long long t1 = clock64(); acc[0] += t1 - t0;\n"
     "    // the ring's first fills need only the winner: start them now\n"),
    ("    // window pass: row i of the rank goes through stage",
     "    long long t2 = clock64(); acc[1] += t2 - t1;\n"
     "    // window pass: row i of the rank goes through stage"),
    ("    // tail blocks outside the window (an interior event without the gate):",
     "    long long t3 = clock64(); acc[2] += t3 - t2;\n"
     "    // tail blocks outside the window (an interior event without the gate):"),
    ("    if (rank == 0 && tid == 0) {\n      atoms[step * B + b] = atom;",
     "    acc[3] += clock64() - t3;\n    if (rank == 0 && tid == 0) {\n      atoms[step * B + b] = atom;"),
    ("    // no rank exits while another may still be behind the last step's barrier\n",
     "    if (tid == 0) {\n"
     "      for (int k = 0; k < 4; ++k) atomicAdd(&g_stamps[k], (unsigned long long)acc[k]);\n"
     "      atomicAdd(&g_stamps[7], 1ull);\n"
     "    }\n"
     "    if (tid == kThreads - 32) atomicAdd(&g_stamps[4], (unsigned long long)acc[2]);\n"
     "    // no rank exits while another may still be behind the last step's barrier\n"),
    # a ring of MP_STAGES stages where that is set, or as many as fit
    ("  if (lanes && plan.stages > kWarps) plan.stages -= plan.stages % kWarps;\n",
     "  if (lanes && plan.stages > kWarps) plan.stages -= plan.stages % kWarps;\n"
     "  if (getenv(\"MP_STAGES\")) {\n"
     "    const long long ring = atoi(getenv(\"MP_STAGES\"));\n"
     "    plan.stages = (int)(ring < stages && ring < kMaxStages ? ring\n"
     "                        : stages < kMaxStages ? stages : kMaxStages);\n"
     "  }\n"),
]

VARIANTS = {
    "no lane reduction": (
        "const int first = __reduce_min_sync(\n"
        "                  0xffffffffu, ordered_back(m) == cm ? cb * 128 + at : INT_MAX);",
        "const int first = cb + 0 * at;"),
    "no lane-table stores": (
        "if constexpr (kLanes) ltbl[i * tstride + blk] = blane;",
        "if constexpr (kLanes) { if (blane < 0) ltbl[i * tstride + blk] = blane; }"),
    "no lane read after a rescan": (
        "rlane[i] = window_wins ? nl : rescan ? ltbl[i * tstride + oc] : rlane[i];",
        "rlane[i] = window_wins ? nl : rescan ? 0 : rlane[i];"),
}

READER = '''
extern "C" int stamps_{tag}(unsigned long long* out) {{
  const cudaError_t err = cudaMemcpyFromSymbol(out, enc::g_stamps, 8 * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {{}};
  return (int)cudaMemcpyToSymbol(enc::g_stamps, zero, sizeof(zero));
}}
'''


def patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"anchor not found once in mp_window.cuh: {old[:60]!r}")
    return text.replace(old, new)


def stamped_sources(dst: Path, variant: str | None) -> Path:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "mptpu_torch" / "csrc", dst)
    header = (dst / "mp_window.cuh").read_text()
    for old, new in STAMPS + ([VARIANTS[variant]] if variant else []):
        header = patch(header, old, new)
    (dst / "mp_window.cuh").write_text(header)
    for name, tag in (("mp_fused.cu", "fused"), ("mp_lane.cu", "lane")):
        (dst / name).write_text((dst / name).read_text() + READER.format(tag=tag))
    return dst


def build_all(dirs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together; one library per copy."""
    from mptpu_torch import kernels

    nvcc = kernels._nvcc()
    procs = []
    for name, src in dirs.items():
        for stem in ("mp_fused", "mp_lane"):
            obj = src / f"{stem}.o"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(src), "-c", str(src / f"{stem}.cu"),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs: dict[str, list[Path]] = {}
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        objs.setdefault(name, []).append(obj)
    libs = {}
    for name, paths in objs.items():
        so = dirs[name] / "libstamped.so"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        *map(str, paths), "-o", str(so)], check=True)
        lib = ctypes.CDLL(str(so))
        for entry in ("mp_fused_encode", "mp_fused_encode_lane"):
            getattr(lib, entry).argtypes = kernels._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        for tag in ("fused", "lane"):
            getattr(lib, f"stamps_{tag}").argtypes = [ctypes.c_void_p]
            getattr(lib, f"stamps_{tag}").restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--clusters", type=int, nargs="+", default=[2, 8])
    parser.add_argument("--stages", type=int, nargs="+", default=[0, 16],
                        help="ring depths (as many as fit where fewer do); 0: the plan's own")
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("encode_stamps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mptpu_torch import parity_mode
    from mptpu_torch.ops import unit_norm
    from mptpu_torch.sparse import dictionary_gram, encode_state, fast_geometry

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    dirs = {"stamped": stamped_sources(OUT / "stamped", None)}
    if args.variants:
        for i, variant in enumerate(VARIANTS):
            dirs[variant] = stamped_sources(OUT / f"variant{i}", variant)
    libs = build_all(dirs)

    parity_mode()
    dev = torch.device("cuda", 0)
    cfg = cs.BENCH
    B, N, A, n = cfg["batch"], cfg["n_atoms"], cfg["atom_size"], cfg["n_samples"]
    S, block = cfg["n_steps"], cfg["block"]
    geom = fast_geometry(n, A, block)
    d_np, sig_np = cs.bench_inputs(cfg)
    d2 = unit_norm(torch.from_numpy(d_np).to(dev))
    gram_p = F.pad(dictionary_gram(d2), (0, 1))
    fm0, bm0, res0 = encode_state(torch.from_numpy(sig_np).to(dev), d2, geom)
    bm0 = F.pad(bm0, (0, geom.nb_pad - geom.n_blocks), value=-3e38)
    lanes0 = cs.initial_lanes(fm0, geom)

    def run(lib, lanes: bool, cluster: int) -> str:
        fm, bm, res, ln = fm0.clone(), bm0.clone(), res0.clone(), lanes0.clone()
        tail = torch.empty((B, N, A), device=dev)
        events = [torch.empty((S, B), dtype=dt, device=dev)
                  for dt in (torch.int32, torch.int32, torch.float32)]
        tensors = [fm, bm, *([ln] if lanes else []), res, d2, gram_p, tail, *events]
        ints = [B, N, A, geom.W, n, block, geom.pad, geom.n_blocks, bm.shape[-1],
                geom.upd_blocks, geom.tail_start, 1, S, cluster]
        entry = lib.mp_fused_encode_lane if lanes else lib.mp_fused_encode
        read = lib.stamps_lane if lanes else lib.stamps_fused
        sums = (ctypes.c_ulonglong * 8)()

        def call():
            err = entry(*(t.data_ptr() for t in tensors), *ints,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch: CUDA error {err}")

        read(sums)   # zero the sums
        ms = cs.timed(call, 1, dev, warmup=False)
        if read(sums):
            raise RuntimeError("reading the stamps failed")
        per = sums[7] * S   # block-steps
        clipped = int((events[1] > n - A).sum())
        return (f"{ms:.3f} ms; cycles per block and step: select {sums[0] / per:.0f}, surgery "
                f"{sums[1] / per:.0f}, window pass {sums[2] / per:.0f} (last warp "
                f"{sums[4] / per:.0f}), rest {sums[3] / per:.0f}; {clipped} clipped events")

    for stages in args.stages:
        if stages:
            os.environ["MP_STAGES"] = str(stages)
        else:
            os.environ.pop("MP_STAGES", None)
        ring = f"ring of {stages}" if stages else "the plan's ring"
        for cluster in args.clusters:
            for lanes in (False, True):
                name = "K5 cuda_fused_encode_lane" if lanes else "K2 cuda_fused_encode"
                print(f"{name}, clusters of {cluster}, {ring}: "
                      f"{run(libs['stamped'], lanes, cluster)}")
            for variant in VARIANTS if args.variants else ():
                print(f"K5 {variant}, clusters of {cluster}, {ring}: "
                      f"{run(libs[variant], True, cluster)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
