#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``mptpu_torch``) of the greedy
matching-pursuit encoder on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``), then the build of
   the CUDA kernels from ``mptpu_torch/csrc`` and its time;
2. each kernel against its plain PyTorch version, on the card, at the
   bench shapes (32 items, 512 atoms x 512 taps, 16,384 samples,
   block 128), on a planted signal with decisive maxima;
3. three paths through ``sparse_code_fast``, each with the launch counts
   set to 0 just before and read just after: the bench configuration
   (``bench.py``'s inputs and settings; whole-encode kernel, timed), the
   per-step fused path (step kernel) and the unfused path with the
   boundary kernel. Their events on the planted signal must equal the
   naive ``sparse_code``'s;
4. each kernel's time beside its plain version's, its bound and, for the
   boundary kernel, one ``torch.matmul`` computing the same product;
5. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

It needs CUDA and the ``mptpu_torch`` package beside it, and exits with
code 2 without either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench.py:133-139,182-188
BENCH = dict(batch=32, n_atoms=512, atom_size=512, n_samples=16384, n_steps=100, block=128, depth=3)

# published peaks without tensor cores (NVIDIA data sheets): bytes/s, f32 FLOP/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12), "H100": (3.35e12, 67e12)}

# tolerances: the tail dot products are the only sums whose order differs
# between a kernel and its plain version (512-term float32 sums)
TAIL_TOL = dict(rtol=1e-4, atol=1e-4)
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_fast_mp.py:82-87
RESIDUAL_TOL = dict(rtol=1e-3, atol=1e-5)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def planted_signal(cfg, seed: int = 1):
    """(dictionary, signal): per item, n_steps + 20 overlapping interior
    plants (distinct atoms where there are enough) with geometrically falling amplitudes, and
    one clipped plant whose atom runs 212 taps past the end (the largest
    event on even items, so the first step clips there)."""
    rng = np.random.default_rng(seed)
    N, A, n, B = cfg["n_atoms"], cfg["atom_size"], cfg["n_samples"], cfg["batch"]
    d = rng.standard_normal((N, A)).astype(np.float32)
    du = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
    sig = np.zeros((B, 1, n), np.float32)
    n_plants = cfg["n_steps"] + 20
    for i in range(B):
        atoms = rng.choice(N, n_plants, replace=n_plants > N)
        pos = rng.integers(0, n - A, n_plants)
        for k in range(n_plants):
            sig[i, 0, pos[k] : pos[k] + A] += du[atoms[k]] * (10.0 * 0.97**k)
        inside = min(300, A - 1)
        sig[i, 0, n - inside :] += du[rng.integers(N), :inside] * (20.0 if i % 2 == 0 else 6.0)
    return d, sig


def bench_inputs(cfg):
    """bench.py:141-143."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((cfg["n_atoms"], cfg["atom_size"])).astype(np.float32)
    sig = rng.standard_normal((cfg["batch"], 1, cfg["n_samples"])).astype(np.float32)
    return d, sig


def max_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def assert_close(name, a, b, tol):
    import torch

    if not torch.allclose(a, b, **tol):
        fail(f"{name}: max abs err {max_err([(a, b)]):.3e} above {tol}")


def assert_events(name, a, b, with_values=True):
    import torch

    for field in (0, 1):
        if not torch.equal(a[field].cpu(), b[field].cpu()):
            diff = int((a[field].cpu() != b[field].cpu()).sum())
            fail(f"{name}: {('atoms', 'positions')[field]} differ in {diff} events")
    if with_values:
        assert_close(f"{name} values", a[2].cpu(), b[2].cpu(), VALUE_TOL)


def timed(fn, reps: int, dev, warmup: bool = True) -> float:
    """Mean ms of ``fn`` over ``reps`` calls: between CUDA events on a
    card, by the host clock on the CPU (where the harness is rehearsed)."""
    import torch

    if warmup:
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def step_traffic(cfg, geom, positions, table_reads: bool):
    """(bytes, flops) the fused step body must move and compute for the
    events ``positions`` (any shape): per item-step one gram row read and
    the update window read and written (plus the block-max table read when
    the table is an input of each call); per clipped event the N x A x A
    tail product and its N x A write."""
    N, A = cfg["n_atoms"], cfg["atom_size"]
    upd_w = geom.upd_blocks * geom.block
    item_steps = positions.numel()
    clipped = int((positions > cfg["n_samples"] - A).sum())
    per = N * 2 * A + 2 * N * upd_w + (N * geom.n_blocks if table_reads else 0)
    return 4 * (item_steps * per + clipped * N * A), 2 * N * A * A * clipped


def bound(bytes_, flops, peaks):
    t_bytes, t_ops = bytes_ / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run(dev, cfg, peaks, sync):
    """Phases 2-4 on device ``dev``; returns the kernels' records."""
    import torch
    import torch.nn.functional as F

    from mptpu_torch import kernels
    from mptpu_torch.ops import unit_norm
    from mptpu_torch.sparse import (
        boundary_update_plain, cuda_boundary_update, cuda_fused_encode, cuda_fused_step,
        dictionary_gram, encode_state, fast_geometry, fused_encode_plain, fused_step_plain,
        reconstruct_from_events, sparse_code, sparse_code_fast,
    )
    from mptpu_torch.device import no_tf32

    B, N, A, n = cfg["batch"], cfg["n_atoms"], cfg["atom_size"], cfg["n_samples"]
    S, block = cfg["n_steps"], cfg["block"]
    geom = fast_geometry(n, A, block)
    kw = geom._asdict()
    records = {}

    # ---- phase 2: kernels against their plain versions on the planted signal
    d_np, sig_np = planted_signal(cfg)
    d_pl = torch.from_numpy(d_np).to(dev)
    sig_pl = torch.from_numpy(sig_np).to(dev)
    d2 = unit_norm(d_pl)
    gram_p = F.pad(dictionary_gram(d2), (0, 1))
    fm0, bm0, res0 = encode_state(sig_pl, d2, geom)
    bm0_pad = F.pad(bm0, (0, geom.nb_pad - geom.n_blocks), value=-3e38)
    tail_idx = (n - A + torch.arange(A, device=dev))[:, None] + torch.arange(A, device=dev)
    windows = res0[:, tail_idx].contiguous()

    fk, bk = fm0.clone(), bm0.clone()
    fp, bp = fm0.clone(), bm0.clone()
    cuda_boundary_update(fk, bk, windows, d2, geom.tail_start, block)
    boundary_update_plain(fp, bp, windows, d2, geom.tail_start, block)
    sync()
    ts, te = geom.tail_start, geom.tail_start + A
    assert_close("boundary tail", fk[:, :, ts:te], fp[:, :, ts:te], TAIL_TOL)
    assert_close("boundary tmax", bk, bp, TAIL_TOL)
    if not (torch.equal(fk[:, :, :ts], fm0[:, :, :ts]) and torch.equal(fk[:, :, te:], fm0[:, :, te:])):
        fail("boundary kernel wrote outside the tail")
    records["cuda_boundary_update"] = dict(max_abs_err=max_err([(fk, fp), (bk, bp)]))
    print(f"check cuda_boundary_update vs plain: tail max abs err "
          f"{records['cuda_boundary_update']['max_abs_err']:.3e} (tol {TAIL_TOL})")
    del fk, bk, fp, bp

    states = [(fm0.clone(), bm0.clone(), res0.clone()) for _ in range(2)]
    ek = cuda_fused_step(*states[0], d2, gram_p, **kw)
    ep = fused_step_plain(*states[1], d2, gram_p, **kw)
    sync()
    clipped1 = int((ep.positions > n - A).sum())
    if clipped1 == 0:
        fail("the one-step check has no clipped event")
    assert_events("fused step", ek, ep)
    if not torch.equal(ek.values, ep.values):
        fail("fused step: values are not bit-identical")
    for name, i in (("fm", 0), ("bm", 1)):
        assert_close(f"fused step {name}", states[0][i], states[1][i], TAIL_TOL)
    assert_close("fused step residual", states[0][2], states[1][2], RESIDUAL_TOL)
    records["cuda_fused_step"] = dict(max_abs_err=max_err(zip(states[0], states[1])))
    print(f"check cuda_fused_step vs plain, 1 step ({clipped1}/{B} clipped): events equal, "
          f"max abs err {records['cuda_fused_step']['max_abs_err']:.3e}")
    del states

    states = [(fm0.clone(), bm0_pad.clone(), res0.clone()) for _ in range(2)]
    ek = cuda_fused_encode(*states[0], d2, gram_p, n_steps=S, **kw)
    ep = fused_encode_plain(*states[1], d2, gram_p, n_steps=S, **kw)
    sync()
    assert_events("fused encode", ek, ep)
    assert_close("fused encode residual", states[0][2], states[1][2], RESIDUAL_TOL)
    assert_close("fused encode fm", states[0][0], states[1][0], TAIL_TOL)
    assert_close("fused encode bm", states[0][1], states[1][1], TAIL_TOL)
    records["cuda_fused_encode"] = dict(
        max_abs_err=max_err([*zip(states[0], states[1]), (ek.values, ep.values)])
    )
    print(f"check cuda_fused_encode vs plain, {S} steps "
          f"({int((ep.positions > n - A).sum())} clipped events): events equal, max abs err "
          f"{records['cuda_fused_encode']['max_abs_err']:.3e}")
    del states, fm0, bm0, bm0_pad, res0, windows

    # ---- phase 3: the paths, through sparse_code_fast
    d_b_np, sig_b_np = bench_inputs(cfg)
    d_b = torch.from_numpy(d_b_np).to(dev)
    sig_b = torch.from_numpy(sig_b_np).to(dev)
    bench_kw = dict(n_steps=S, fused=True, pipelined=True, whole_loop=True, block=block,
                    depth=cfg["depth"])

    kernels.reset_launches()
    out = sparse_code_fast(sig_b, d_b, **bench_kw)   # warm-up
    sync()
    runs, t_e2e = 3, []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = sparse_code_fast(sig_b, d_b, **bench_kw)
        sync()
        t_e2e.append((time.perf_counter() - t0) * 1e3)
    main_launches = dict(kernels.LAUNCHES)
    on_card = dev.type == "cuda"   # CPU tensors take the plain versions: no launches
    if main_launches["cuda_fused_encode"] != (runs + 1 if on_card else 0):
        fail(f"bench path: {main_launches} for {runs + 1} encodes")
    records["cuda_fused_encode"]["launches"] = main_launches["cuda_fused_encode"]
    if not all(torch.isfinite(t).all() for t in (out.values, out.residual)):
        fail("bench path: non-finite output")
    if tuple(out.atom_indices.shape) != (S, B) or tuple(out.residual.shape) != (B, 1, n):
        fail("bench path: wrong output shapes")
    recon = reconstruct_from_events(out, d_b)
    e_sig = float((sig_b.double() ** 2).sum())
    e_res = float((out.residual.double() ** 2).sum())
    e_err = float(((sig_b - recon).double() ** 2).sum())
    if not e_res < e_sig:
        fail("bench path: residual energy not below signal energy")
    snr = 10 * np.log10(e_sig / e_err)
    ms = float(np.mean(t_e2e))

    d2_b = unit_norm(d_b)
    gram_ms = timed(lambda: dictionary_gram(d2_b), 3, dev)
    corr_ms = timed(lambda: encode_state(sig_b, d2_b, geom), 3, dev)
    gram_b = F.pad(dictionary_gram(d2_b), (0, 1))

    def fresh_encode_state():
        fm, bm, res = encode_state(sig_b, d2_b, geom)
        return fm, F.pad(bm, (0, geom.nb_pad - geom.n_blocks), value=-3e38), res

    enc_ms, found = [], []
    for _ in range(3):
        st = fresh_encode_state()
        enc_ms.append(timed(
            lambda: found.append(cuda_fused_encode(*st, d2_b, gram_b, n_steps=S, **kw)),
            1, dev, warmup=False,
        ))
    ev = found[-1]
    kernel_ms = float(np.mean(enc_ms))
    assert_events("encode kernel vs bench path", ev, (out.atom_indices, out.positions, out.values))
    st = fresh_encode_state()
    sync()
    t0 = time.perf_counter()
    fused_encode_plain(*st, d2_b, gram_b, n_steps=S, **kw)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del st
    b_bytes, b_flops = step_traffic(cfg, geom, ev.positions, table_reads=False)
    b_bytes += 4 * 2 * (B * N * geom.nb_pad + B * (n + A))   # table and residuals, once
    bms, by = bound(b_bytes, b_flops, peaks)
    records["cuda_fused_encode"].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
                                        bound_by=by, library_ms=None)
    print(f"bench path (sparse_code_fast, fused whole-loop, block {block}, depth "
          f"{cfg['depth']}): {S * B / (ms / 1e3):.1f} atoms/s, {ms:.3f} ms per encode "
          f"(runs {', '.join(f'{t:.3f}' for t in t_e2e)}); split: gram {gram_ms:.3f} ms, "
          f"correlation {corr_ms:.3f} ms, kernel {kernel_ms:.3f} ms; launches {main_launches} "
          f"for {runs + 1} encodes; SNR {snr:.3f} dB; "
          f"{int((ev.positions > n - A).sum())} clipped events")
    del gram_b, out, recon

    naive = sparse_code(sig_pl, d_pl, n_steps=S)
    enc = sparse_code_fast(sig_pl, d_pl, **bench_kw)
    assert_events("fused encode vs naive sparse_code (planted)", enc, naive)
    assert_close("fused encode vs naive residual", enc.residual, naive.residual, RESIDUAL_TOL)
    print(f"naive sparse_code vs fused encode, planted full-width signal, {S} steps: events equal")

    for name, path_kw in (
        ("cuda_fused_step", dict(fused=True, pipelined=False)),
        ("cuda_boundary_update", dict(use_pallas=True, block_argmax=True)),
    ):
        kernels.reset_launches()
        res = sparse_code_fast(sig_pl, d_pl, n_steps=S, block=block, **path_kw)
        sync()
        launches = dict(kernels.LAUNCHES)
        if launches[name] != (S if on_card else 0):
            fail(f"{path_kw} path: {launches}, expected {S} launches of {name}")
        records[name]["launches"] = launches[name]
        assert_events(f"{path_kw} path vs naive sparse_code", res, naive)
        assert_close(f"{path_kw} path residual", res.residual, naive.residual, RESIDUAL_TOL)
        print(f"path sparse_code_fast({path_kw}), planted signal: launches {launches}, "
              f"events equal to naive")
    del naive, enc, res

    # ---- phase 4: per-kernel times
    fm, bm, res = encode_state(sig_b, d2_b, geom)
    windows = res[:, tail_idx].contiguous()
    k3_ms = timed(lambda: cuda_boundary_update(fm, bm, windows, d2_b, geom.tail_start, block), 20, dev)
    k3_plain = timed(lambda: boundary_update_plain(fm, bm, windows, d2_b, geom.tail_start, block), 5, dev)

    def library_call():
        with no_tf32():
            return torch.matmul(d2_b, windows.transpose(1, 2))

    k3_lib = timed(library_call, 20, dev)
    k3_bytes = 4 * (B * A * A + N * A + B * N * A + B * N * (A // block))
    bms, by = bound(k3_bytes, 2 * B * N * A * A, peaks)
    records["cuda_boundary_update"].update(ms=k3_ms, plain_ms=k3_plain, bound_ms=bms, bound_by=by,
                                           library_ms=k3_lib)
    del windows

    gram_b = F.pad(dictionary_gram(d2_b), (0, 1))
    reps, k1_pos = 20, []
    k1_ms = timed(
        lambda: k1_pos.append(cuda_fused_step(fm, bm, res, d2_b, gram_b, **kw).positions),
        reps, dev, warmup=False,
    )
    k1_pos = torch.stack(k1_pos)
    k1_plain = timed(lambda: fused_step_plain(fm, bm, res, d2_b, gram_b, **kw), 5, dev)
    k1_bytes, k1_flops = step_traffic(cfg, geom, k1_pos, table_reads=True)
    bms, by = bound(k1_bytes / reps, k1_flops / reps, peaks)
    records["cuda_fused_step"].update(ms=k1_ms, plain_ms=k1_plain, bound_ms=bms, bound_by=by,
                                      library_ms=None)
    for name, r in records.items():
        lib = "" if r["library_ms"] is None else f", library (torch.matmul) {r['library_ms']:.4f} ms"
        print(f"time {name}: {r['ms']:.4f} ms per launch, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")
    return records


SOURCES = {
    "cuda_fused_step": ("mptpu_torch/csrc/mp_fused.cu", "mptpu/sparse/pallas_fused_mp.py:289"),
    "cuda_fused_encode": ("mptpu_torch/csrc/mp_fused.cu", "mptpu/sparse/pallas_fused_mp.py:1219"),
    "cuda_boundary_update": ("mptpu_torch/csrc/mp_boundary.cu", "mptpu/sparse/pallas_mp.py:58"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "mptpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the mptpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mptpu_torch import kernels, parity_mode

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    print(f"peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s f32")

    t0 = time.perf_counter()
    kernels.library()
    regs = [ln.strip() for ln in kernels.build_log.splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(regs)}")

    parity_mode()
    dev = torch.device("cuda", 0)
    records = run(dev, BENCH, peaks, torch.cuda.synchronize)

    line = []
    for name, r in records.items():
        source, replaces = SOURCES[name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
