"""mptpu_torch's fast MP engine against mptpu's on the same numpy inputs.

mptpu runs on JAX-CPU with its Pallas kernels in interpret mode, exactly
as tests/test_fast_mp.py runs them; the port runs on device="cpu", where
every kernel wrapper takes its plain PyTorch version. Signals are planted
atom sums with decisive maxima and clipped plants (tests/test_fast_mp.py
:209-226). Tolerances are tests/test_fast_mp.py:77-87's: events
identical, values rtol 1e-4 / atol 1e-5, residual rtol 1e-3 / atol 1e-5;
the gram is a convolution (rtol 1e-5 / atol 1e-5).
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mptpu import sparse as jsp
from mptpu.ops import unit_norm as j_unit_norm
from mptpu.sparse.pallas_fused_mp import fused_step_applicable as j_applicable
from mptpu.sparse.pallas_fused_mp import (
    pallas_fused_encode,
    pallas_fused_encode_lane,
    pallas_fused_step,
    pallas_fused_step_pipelined,
)
from mptpu.sparse.pallas_mp import pallas_boundary_update
from mptpu_torch import kernels
from mptpu_torch import sparse as tsp
from mptpu_torch.sparse import cuda_fused_mp, cuda_mp
from mptpu_torch.sparse.fast_mp import fast_geometry

RNG = np.random.default_rng(31)
D16 = RNG.standard_normal((16, 128)).astype(np.float32)
D8 = RNG.standard_normal((8, 128)).astype(np.float32)


def planted(d, batch, n):
    """tests/test_fast_mp.py:216-226 for any (d, batch, n)."""
    du = np.asarray(j_unit_norm(jnp.asarray(d)))
    n_atoms, A = du.shape
    sig = np.zeros((batch, 1, n), np.float32)
    for i in range(batch):
        for k in range(8):
            pos = (37 + 211 * (i + 1) * (k + 1)) % (n - A)
            sig[i, 0, pos : pos + A] += du[(3 * i + k) % n_atoms] * (5.0 * 0.8**k)
        sig[i, 0, -64:] += du[(7 * i) % n_atoms, :64] * 4.0
    return sig


def boundary_heavy():
    """tests/test_fast_mp.py:163-172: several clipped plants per item."""
    du = np.asarray(j_unit_norm(jnp.asarray(D8)))
    sig = np.zeros((3, 1, 512), np.float32)
    sig[0, 0, 448:] = du[2, :64] * 5.0
    sig[0, 0, 500:] += du[4, :12] * 4.0
    sig[0, 0, 100:228] = du[5] * 3.0
    sig[1, 0, 384:] = du[1] * 2.0
    sig[1, 0, 400:] += du[7, :112] * 6.0
    sig[1, 0, 0:128] = du[3] * 1.5
    sig[2, 0, 420:] = du[6, :92] * 7.0
    sig[2, 0, 200:328] = du[0] * 2.0
    return sig


def assert_same(j, t):
    np.testing.assert_array_equal(t.atom_indices.numpy(), np.asarray(j.atom_indices))
    np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.residual.numpy(), np.asarray(j.residual), rtol=1e-3, atol=1e-5)


def run_both(d, sig, n_steps, **kw):
    j = jsp.sparse_code_fast(jnp.asarray(sig), jnp.asarray(d), n_steps=n_steps, **kw)
    t = tsp.sparse_code_fast(torch.from_numpy(sig), torch.from_numpy(d), n_steps=n_steps, **kw)
    return j, t


def test_dictionary_gram_matches_mptpu():
    d = np.array(j_unit_norm(jnp.asarray(D16)))
    j = jsp.dictionary_gram(jnp.asarray(d))
    t = tsp.dictionary_gram(torch.from_numpy(d))
    assert t.shape == (16, 16, 255)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(block=128, block_argmax=True),
        dict(block=128, block_argmax=True, use_pallas=True),
        dict(block=128, use_pallas=True),
        dict(block=128, fused=True, pipelined=False),
        dict(block=128, fused=True, pipelined=False, gate_tail=False),
        dict(block=128, fused=True, whole_loop=True),
        dict(block=128, fused=True, whole_loop=True, gate_tail=False, depth=3),
    ],
    ids=["flat", "block_argmax", "pallas_tail", "pallas_tail_flat", "fused_step",
         "fused_step_ungated", "whole_loop", "whole_loop_ungated"],
)
def test_sparse_code_fast_modes_match_mptpu(kw):
    sig = planted(D16, 4, 1024)
    j, t = run_both(D16, sig, 9, **kw)
    assert_same(j, t)


@pytest.mark.parametrize("gate_tail", [True, False])
def test_fused_boundary_heavy_matches_mptpu_and_naive(gate_tail):
    sig = boundary_heavy()
    j, t = run_both(D8, sig, 8, block=128, fused=True, pipelined=False, gate_tail=gate_tail)
    assert (t.positions > 512 - 128).sum() >= 3
    assert_same(j, t)
    naive = tsp.sparse_code(torch.from_numpy(sig), torch.from_numpy(D8), n_steps=8)
    assert torch.equal(naive.atom_indices, t.atom_indices)
    assert torch.equal(naive.positions, t.positions)


@pytest.mark.parametrize(
    "kw",
    [dict(pipelined=True), dict(whole_loop=True, lane_table=True)],
    ids=["pipelined_step", "lane_table"],
)
def test_unported_kernels_take_the_plain_version_on_cpu(kw):
    """The pipelined step and the lane-table encode are pinned bit-identical
    to the per-step kernel (tests/test_fast_mp.py:137-155, 260-293). On a
    CPU tensor no kernel can launch: their wrappers take the plain versions,
    whose results equal mptpu's and the per-step engine's."""
    kernels.reset_launches()
    sig = planted(D16, 3, 1024)
    j, t = run_both(D16, sig, 7, block=128, fused=True, **kw)
    assert_same(j, t)
    _, per_step = run_both(D16, sig, 7, block=128, fused=True, pipelined=False)
    assert torch.equal(t.residual, per_step.residual)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def planted_lane(d, batch, n=1024):
    """tests/test_fast_mp.py:270-279."""
    du = np.asarray(j_unit_norm(jnp.asarray(d)))
    n_atoms, A = du.shape
    sig = np.zeros((batch, 1, n), np.float32)
    for i in range(batch):
        for k in range(8):
            pos = (53 + 199 * (i + 1) * (k + 1)) % (n - A)
            sig[i, 0, pos : pos + A] += du[(5 * i + k) % n_atoms] * (5.0 * 0.8**k)
        sig[i, 0, -64:] += du[(3 * i + 1) % n_atoms, :64] * 4.0
    return sig


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_pipelined_step_matches_unpipelined_and_mptpu(batch):
    """tests/test_fast_mp.py:137-155 across the two packages: pipelined and
    unpipelined give identical events and a bit-identical residual in the
    port, and the port's pipelined events are mptpu's (Pallas pipelined
    kernel in interpret mode)."""
    sig = planted(D16, batch, 1024)
    j, a = run_both(D16, sig, 7, block=128, fused=True, pipelined=True)
    b = tsp.sparse_code_fast(torch.from_numpy(sig), torch.from_numpy(D16), n_steps=7,
                             block=128, fused=True, pipelined=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert_same(j, a)


def lane_state(d, sig, block=128):
    """Initial (fm, bm, lanes, residual), gram_p, d2 and geometry of the
    lane-table encode, built as sparse_code_fast builds them."""
    import torch.nn.functional as F

    d2 = tsp.fast_mp.unit_norm(torch.from_numpy(d))
    geom = fast_geometry(sig.shape[-1], d.shape[-1], block)
    fm, bm, res = tsp.encode_state(torch.from_numpy(sig), d2, geom)
    bm = F.pad(bm, (0, geom.nb_pad - geom.n_blocks), value=tsp.fast_mp.TABLE_PAD)
    lanes = torch.argmax(fm.reshape(*fm.shape[:2], geom.n_blocks, block), dim=-1)
    lanes = F.pad(lanes.to(torch.int32), (0, geom.nb_pad - geom.n_blocks))
    gram_p = F.pad(tsp.dictionary_gram(d2), (0, 1))
    return (fm, bm, lanes, res), gram_p, d2, geom


@pytest.mark.parametrize("batch,depth,gate_tail", [(4, 2, True), (5, 3, True), (4, 2, False)])
def test_lane_table_encode_matches_mptpu(batch, depth, gate_tail):
    """tests/test_fast_mp.py:260-293 across the two packages. Events
    identical, values rtol 1e-4 / atol 1e-5, residual rtol 1e-3 / atol 1e-5
    against mptpu's lane-table kernel (interpret mode); bit-identical to the
    port's own whole-encode path; and after the encode the tables describe
    the final map: lanes == argmax and bm == max of every real block.
    Without the tail gate every step rewrites the tail blocks, which then
    lie outside the window of an interior event."""
    sig = planted_lane(D16, batch)
    kw = dict(block=128, fused=True, whole_loop=True, depth=depth, gate_tail=gate_tail)
    j, t = run_both(D16, sig, 9, lane_table=True, **kw)
    assert (t.positions > 1024 - 128).any()   # the tail branch kept the lanes too
    assert_same(j, t)
    whole = tsp.sparse_code_fast(torch.from_numpy(sig), torch.from_numpy(D16), n_steps=9, **kw)
    for x, y in zip(t, whole):
        assert torch.equal(x, y)

    state, gram_p, d2, geom = lane_state(D16, sig)
    ev = tsp.cuda_fused_encode_lane(*state, d2, gram_p, n_steps=9, gate_tail=gate_tail,
                                    **geom._asdict())
    assert torch.equal(ev.atoms, t.atom_indices) and torch.equal(ev.positions, t.positions)
    fm, bm, lanes, _ = state
    blocks = fm.reshape(batch, 16, geom.n_blocks, 128)
    assert torch.equal(lanes[..., : geom.n_blocks].long(), blocks.argmax(-1))
    assert torch.equal(bm[..., : geom.n_blocks], blocks.amax(-1))
    assert not lanes[..., geom.n_blocks :].any()         # pad columns stay zero
    assert (bm[..., geom.n_blocks :] == tsp.fast_mp.TABLE_PAD).all()


def test_lane_table_plain_selects_from_the_tables():
    """fused_encode_lane_plain reads the winner's position from lanes and
    its value from bm, never from the map: shifting the winner's lane entry
    shifts the event, and scaling its bm entry scales the value."""
    sig = planted_lane(D16, 2)
    state, gram_p, d2, geom = lane_state(D16, sig)
    ref = tsp.fused_encode_lane_plain(*(t.clone() for t in state), d2, gram_p, n_steps=1,
                                      **geom._asdict())
    fm, bm, lanes, res = (t.clone() for t in state)
    flat = int(torch.argmax(bm[0].reshape(-1)))
    atom, blk = divmod(flat, bm.shape[-1])
    lanes[0, atom, blk] += 1
    bm[0, atom, blk] *= 2.0
    ev = tsp.fused_encode_lane_plain(fm, bm, lanes, res, d2, gram_p, n_steps=1, **geom._asdict())
    assert int(ev.atoms[0, 0]) == int(ref.atoms[0, 0]) == atom
    assert int(ev.positions[0, 0]) == int(ref.positions[0, 0]) + 1
    assert float(ev.values[0, 0]) == 2.0 * float(ref.values[0, 0])
    assert torch.equal(ev.positions[0, 1:], ref.positions[0, 1:])


# clusters of 16, 8, 4, 2, 1 blocks of the cluster step kernel that an H100
# holds at once (cudaOccupancyMaxActiveClusters; one block fills an SM)
STEP_RESIDENT = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


@pytest.mark.parametrize(
    "batch,n_atoms,want",
    [(32, 512, 8), (4, 512, 16), (1, 512, 16), (3, 16, 16), (64, 512, 2), (200, 512, 1),
     (4, 12, 4), (40, 512, 8), (8, 512, 8), (4, 24, 8)],
)
def test_cluster_size_rule(batch, n_atoms, want):
    """The divisor of the atoms among 16, 8, 4, 2, 1 with the least
    waves * (1 / size + 1 / 16), the larger among equals: up to 7 items take
    16 blocks each; 32 items 8 blocks each in three waves of 15 clusters
    (0.5625) rather than 16 in five waves of 7 or 4 in two waves of 30
    (0.625 both); 64 items fit 66 clusters of 2 at once; 200 items take one
    block each in two waves."""
    assert tsp.cluster_size(batch, n_atoms, STEP_RESIDENT.get) == want


def test_cluster_size_skips_sizes_the_card_does_not_hold():
    """A size of which the card holds no cluster is never chosen, and only
    divisors of the atoms are asked about."""
    asked = []

    def resident(c):
        asked.append(c)
        return {4: 0, 2: 7, 1: 20}[c]

    assert tsp.cluster_size(6, 12, resident) == 2
    assert asked == [4, 2, 1]
    assert tsp.cluster_size(6, 7, lambda c: 100) == 1


@pytest.mark.parametrize("kind", ["grid", "fori"])
@pytest.mark.parametrize("vpu", [False, True])
def test_probe_on_cpu_takes_the_plain_version(kind, vpu):
    """Both probe kinds return the (8, 128) tile after `steps` updates
    acc = acc * 1.000001 + 1 with product and sum rounded separately in
    float32 (scripts/grid_overhead_probe.py:55-81), bit for bit."""
    from mptpu_torch.probes import probe_launches, probe_plain

    kernels.reset_launches()
    steps = 40
    acc = np.float32(0.0)
    for _ in range(steps if vpu else 0):
        acc = np.float32(np.float32(acc * np.float32(1.000001)) + np.float32(1.0))
    tile = probe_launches(kind, vpu, steps, device="cpu")
    assert tile.shape == (8, 128) and tile.dtype == torch.float32
    assert torch.equal(tile, torch.full((8, 128), float(acc)))
    assert torch.equal(tile, probe_plain(vpu, steps))
    assert kernels.LAUNCHES["probe_launches"] == 0
    with pytest.raises(ValueError):
        probe_launches("scan", vpu, steps, device="cpu")


@pytest.mark.parametrize("programmatic", [False, True], ids=["plain", "chained"])
@pytest.mark.parametrize("vpu", [False, True])
def test_probe_programmatic_on_cpu_takes_the_plain_version(vpu, programmatic):
    """probe_launches("grid", ..., programmatic=...) returns the tile of
    probe_plain bit for bit either way: chained launches change when a
    launch may start, not what it computes. The in-kernel loop has no
    launches to chain and refuses the flag."""
    from mptpu_torch.probes import probe_launches, probe_plain

    kernels.reset_launches()
    tile = probe_launches("grid", vpu, 40, device="cpu", programmatic=programmatic)
    assert torch.equal(tile, probe_plain(vpu, 40))
    assert torch.equal(tile, probe_launches("fori", vpu, 40, device="cpu"))
    assert kernels.LAUNCHES["probe_launches"] == 0
    with pytest.raises(ValueError, match="programmatic"):
        probe_launches("fori", vpu, 40, device="cpu", programmatic=True)


def test_whole_loop_batch_rule_falls_back_to_per_step():
    """whole_loop needs depth + 1 <= batch <= 128 (fast_mp.py:170)."""
    sig = planted(D16, 2, 1024)
    j, t = run_both(D16, sig, 7, block=128, fused=True, whole_loop=True)
    assert_same(j, t)


def test_boundary_update_plain_matches_pallas_kernel():
    B, N, A, block = 2, 16, 128, 128
    g = fast_geometry(1024, A, block)
    fm = RNG.standard_normal((B, N, g.W)).astype(np.float32)
    bm = RNG.standard_normal((B, N, g.n_blocks)).astype(np.float32)
    windows = RNG.standard_normal((B, A, A)).astype(np.float32)
    d = np.array(j_unit_norm(jnp.asarray(D16)))
    jf, jb = pallas_boundary_update(
        jnp.asarray(fm), jnp.asarray(bm), jnp.asarray(windows), jnp.asarray(d), g.tail_start, block
    )
    tf, tb = torch.from_numpy(fm.copy()), torch.from_numpy(bm.copy())
    out = tsp.cuda_boundary_update(tf, tb, torch.from_numpy(windows), torch.from_numpy(d),
                                   g.tail_start, block)
    assert out[0] is tf and out[1] is tb     # in place
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)


def test_fused_step_applicable_matches_mptpu():
    for n_samples in (512, 1000, 1024, 16384):
        for atom_size in (64, 96, 128, 256, 512):
            for block in (64, 128, 256, 512):
                for n_atoms in (8, 12, 16, 512):
                    pad = ((atom_size - 1 + block - 1) // block) * block
                    args = (n_samples, atom_size, block, pad, n_atoms)
                    assert tsp.fused_step_applicable(*args, "cpu") == j_applicable(*args)
    assert not tsp.fused_step_applicable(1024, 128, 128, 128, 16, "meta")


def test_no_kernel_launches_on_cpu():
    kernels.reset_launches()
    sig = planted(D16, 3, 1024)
    for kw in (dict(fused=True, whole_loop=True), dict(fused=True, pipelined=False),
               dict(fused=True), dict(fused=True, whole_loop=True, lane_table=True),
               dict(use_pallas=True, block_argmax=True)):
        tsp.sparse_code_fast(torch.from_numpy(sig), torch.from_numpy(D16), n_steps=3,
                             block=128, **kw)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# clusters of 8, 4, 2, 1 blocks of the whole-encode kernel that an H100 holds
# at once at the bench shapes (cudaOccupancyMaxActiveClusters)
RESIDENT = {8: 15, 4: 30, 2: 66, 1: 132}


@pytest.mark.parametrize(
    "batch,n_atoms,want",
    [(32, 512, 2), (4, 512, 8), (15, 512, 8), (16, 512, 4), (30, 512, 4), (31, 512, 2),
     (66, 512, 2), (67, 512, 1), (128, 512, 1), (5, 7, 1), (3, 12, 4), (40, 12, 2), (200, 512, 1)],
)
def test_encode_cluster_size_rule(batch, n_atoms, want):
    """The largest of 8, 4, 2, 1 blocks per item that divides the atoms and
    whose `batch` clusters are all resident at once: 32 items where only 30
    clusters of 4 fit take 2; 1 when nothing larger divides or fits."""
    assert tsp.encode_cluster_size(batch, n_atoms, RESIDENT.get) == want


def test_encode_cluster_size_asks_only_divisors():
    asked = []

    def resident(c):
        asked.append(c)
        return 1000

    assert tsp.encode_cluster_size(4, 12, resident) == 4
    assert asked == [4]


def encode_state_np(batch, gate_tail_signal=planted_lane):
    """Initial state of the whole-encode kernels as numpy arrays, built as
    sparse_code_fast builds it (lane-padded table)."""
    sig = gate_tail_signal(D16, batch)
    (fm, bm, _, res), gram_p, d2, geom = lane_state(D16, sig)
    return [t.numpy() for t in (fm, bm, res, d2, gram_p)], geom


@pytest.mark.parametrize("batch,gate_tail", [(4, True), (5, True), (4, False)])
def test_fused_encode_wrapper_matches_pallas_fused_encode(batch, gate_tail):
    """cuda_fused_encode on CPU tensors (its plain version) against mptpu's
    pallas_fused_encode in interpret mode on the same initial state: events
    identical, values rtol 1e-4 / atol 1e-5, residual rtol 1e-3 / atol 1e-5,
    map and table (whose tails are sums taken in another order) rtol 1e-4 /
    atol 1e-4; the result does not depend on `cluster`."""
    arrays, geom = encode_state_np(batch)
    kw = geom._asdict()
    jf, jb, jr, ja, jp, jv = pallas_fused_encode(
        *(jnp.asarray(a) for a in arrays), n_steps=9, depth=2, gate_tail=gate_tail,
        interpret=True, **kw)
    kernels.reset_launches()
    for cluster in (None, 4):
        fm, bm, res, d2, gram_p = (torch.from_numpy(a.copy()) for a in arrays)
        ev = tsp.cuda_fused_encode(fm, bm, res, d2, gram_p, n_steps=9, gate_tail=gate_tail,
                                   cluster=cluster, **kw)
        assert (ev.positions > 1024 - 128).any()
        np.testing.assert_array_equal(ev.atoms.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ev.positions.numpy(), np.asarray(jp))
        np.testing.assert_allclose(ev.values.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res.numpy(), np.asarray(jr), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(fm.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bm.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    assert kernels.LAUNCHES["cuda_fused_encode"] == 0


@pytest.mark.parametrize("cluster", [0, 3, 5, 16, 32])
def test_fused_encode_refuses_a_bad_cluster(cluster):
    """1, 2, 4 or 8 blocks per item, and a divisor of the atoms (16 here)."""
    arrays, geom = encode_state_np(4)
    with pytest.raises(ValueError, match="cluster"):
        tsp.cuda_fused_encode(*(torch.from_numpy(a) for a in arrays), n_steps=1, cluster=cluster,
                              **geom._asdict())


@pytest.mark.parametrize("cluster", [0, 3, 5, 16, 32])
def test_fused_encode_lane_refuses_a_bad_cluster(cluster):
    """The lane-table encode takes the whole encode's clusters: 1, 2, 4 or 8
    blocks per item and a divisor of the atoms (16 here), on CPU tensors
    too."""
    sig = planted_lane(D16, 4)
    state, gram_p, d2, geom = lane_state(D16, sig)
    with pytest.raises(ValueError, match="cluster"):
        tsp.cuda_fused_encode_lane(*state, d2, gram_p, n_steps=1, cluster=cluster,
                                   **geom._asdict())


@lru_cache(maxsize=None)
def pallas_lane_reference(gate_tail: bool):
    """mptpu's pallas_fused_encode_lane in interpret mode from the planted
    lane state of 4 items, 9 steps: (fm, bm, residual, atoms, positions,
    values) as numpy arrays."""
    sig = planted_lane(D16, 4)
    (fm, bm, lanes, res), gram_p, d2, geom = lane_state(D16, sig)
    out = pallas_fused_encode_lane(
        *(jnp.asarray(t.numpy()) for t in (fm, bm, lanes, res, d2, gram_p)), n_steps=9, depth=2,
        gate_tail=gate_tail, interpret=True, **geom._asdict())
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("gate_tail", [True, False], ids=["gated", "ungated"])
def test_fused_encode_lane_wrapper_matches_pallas_kernel(cluster, gate_tail):
    """cuda_fused_encode_lane on CPU tensors (its plain version) against
    mptpu's pallas_fused_encode_lane in interpret mode on the same initial
    state, at every cluster the wrapper takes: events identical, values
    rtol 1e-4 / atol 1e-5, residual rtol 1e-3 / atol 1e-5, map and table
    (whose tails are sums taken in another order) rtol 1e-4 / atol 1e-4; the
    result does not depend on `cluster`, and the lane table describes the
    final map."""
    jf, jb, jr, ja, jp, jv = pallas_lane_reference(gate_tail)
    sig = planted_lane(D16, 4)
    state, gram_p, d2, geom = lane_state(D16, sig)
    kernels.reset_launches()
    ev = tsp.cuda_fused_encode_lane(*state, d2, gram_p, n_steps=9, gate_tail=gate_tail,
                                    cluster=cluster, **geom._asdict())
    fm, bm, lanes, res = state
    assert (ev.positions > 1024 - 128).any()
    np.testing.assert_array_equal(ev.atoms.numpy(), ja)
    np.testing.assert_array_equal(ev.positions.numpy(), jp)
    np.testing.assert_allclose(ev.values.numpy(), jv, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.numpy(), jr, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(fm.numpy(), jf, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bm.numpy(), jb, rtol=1e-4, atol=1e-4)
    blocks = fm.reshape(4, 16, geom.n_blocks, 128)
    assert torch.equal(lanes[..., : geom.n_blocks].long(), blocks.argmax(-1))
    assert not lanes[..., geom.n_blocks :].any()
    assert kernels.LAUNCHES["cuda_fused_encode_lane"] == 0


def test_fused_wrappers_refuse_shapes_that_fail_the_gate():
    """The kernel wrappers' argument check refuses shapes outside
    fused_step_applicable (here 1,000 samples: not a multiple of 128) and a
    map whose width is not n_blocks * block, before anything is launched."""
    d2 = tsp.fast_mp.unit_norm(torch.from_numpy(D16))
    gram_p = torch.zeros(16, 16, 256)
    for n, widen in ((1000, 0), (1024, 128)):
        geom = fast_geometry(n, 128, 128)
        fm = torch.zeros(2, 16, geom.W + widen)
        bm = torch.zeros(2, 16, geom.n_blocks)
        res = torch.zeros(2, n + 128)
        with pytest.raises(ValueError, match="gate"):
            cuda_fused_mp._check_step_args(fm, bm, res, d2, gram_p, **geom._asdict())


def test_bulk_copy_alignment_check():
    """The whole-encode kernel's bulk copies need 16-byte aligned windows
    and gram rows: a misaligned storage offset or a block that is not a
    multiple of 4 floats raises; aligned tensors pass."""
    fm = torch.zeros(2 * 16 * 1280 + 1)
    gram_p = torch.zeros(16 * 16 * 256 + 1)
    aligned = (fm[:-1].view(2, 16, 1280), gram_p[:-1].view(16, 16, 256))
    assert aligned[0].data_ptr() % 16 == 0
    cuda_fused_mp.check_bulk_copy_alignment(*aligned, atom_size=128, block=128)
    with pytest.raises(ValueError, match="fm"):
        cuda_fused_mp.check_bulk_copy_alignment(fm[1:].view(2, 16, 1280), aligned[1], 128, 128)
    with pytest.raises(ValueError, match="gram_p"):
        cuda_fused_mp.check_bulk_copy_alignment(aligned[0], gram_p[1:].view(16, 16, 256), 128, 128)
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_fused_mp.check_bulk_copy_alignment(*aligned, atom_size=128, block=130)
    with pytest.raises(ValueError, match="multiples of 4"):
        cuda_fused_mp.check_bulk_copy_alignment(*aligned, atom_size=126, block=128)


def test_boundary_copy_alignment_check():
    """The boundary kernel copies 16 bytes at a time along the taps: rows
    must be a multiple of 4 floats and the tensors 16-byte aligned."""
    windows = torch.zeros(2 * 128 * 128 + 1)
    d = torch.zeros(16 * 128 + 1)
    ok = (windows[:-1].view(2, 128, 128), d[:-1].view(16, 128))
    cuda_mp.check_copy_alignment(*ok)
    with pytest.raises(ValueError, match="windows"):
        cuda_mp.check_copy_alignment(windows[1:].view(2, 128, 128), ok[1])
    with pytest.raises(ValueError, match="d:"):
        cuda_mp.check_copy_alignment(ok[0], d[1:].view(16, 128))
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_mp.check_copy_alignment(torch.zeros(2, 126, 126), torch.zeros(16, 126))


@pytest.mark.parametrize("block", [64, 128])
def test_boundary_update_wrapper_matches_pallas_kernel_in_place(block):
    """cuda_boundary_update on CPU tensors against pallas_boundary_update
    (interpret mode) at the 16-atom / 128-tap / 1,024-sample shapes, for a
    table block equal to the kernel's 128-position tile and a smaller one:
    tail and maxima rtol 1e-4 / atol 1e-4, nothing written outside the tail
    and its table blocks, a lane-padded table's pad columns untouched."""
    B, N, A = 3, 16, 128
    g = fast_geometry(1024, A, block)
    rng = np.random.default_rng(17)
    fm = rng.standard_normal((B, N, g.W)).astype(np.float32)
    bm = rng.standard_normal((B, N, g.nb_pad)).astype(np.float32)
    windows = rng.standard_normal((B, A, A)).astype(np.float32)
    d = np.array(j_unit_norm(jnp.asarray(D16)))
    jf, jb = pallas_boundary_update(
        jnp.asarray(fm), jnp.asarray(bm[..., : g.n_blocks]), jnp.asarray(windows), jnp.asarray(d),
        g.tail_start, block)
    tf, tb = torch.from_numpy(fm.copy()), torch.from_numpy(bm.copy())
    kernels.reset_launches()
    tsp.cuda_boundary_update(tf, tb, torch.from_numpy(windows), torch.from_numpy(d),
                             g.tail_start, block)
    assert kernels.LAUNCHES["cuda_boundary_update"] == 0
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb[..., : g.n_blocks].numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    ts, te = g.tail_start, g.tail_start + A
    np.testing.assert_array_equal(tf[:, :, :ts].numpy(), fm[:, :, :ts])
    np.testing.assert_array_equal(tf[:, :, te:].numpy(), fm[:, :, te:])
    np.testing.assert_array_equal(tb[..., g.n_blocks :].numpy(), bm[..., g.n_blocks :])
    t0 = ts // block
    untouched = np.ones(g.nb_pad, bool)
    untouched[t0 : t0 + A // block] = False
    np.testing.assert_array_equal(tb.numpy()[..., untouched], bm[..., untouched])


STEP_KERNELS = {
    "fused_step": (tsp.cuda_fused_step, pallas_fused_step, False),
    "fused_step_pipelined": (tsp.cuda_fused_step_pipelined, pallas_fused_step_pipelined, True),
}


@pytest.mark.parametrize("gate_tail", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("kernel", list(STEP_KERNELS))
def test_step_chain_equals_single_calls_and_mptpu(kernel, gate_tail):
    """`cuda_fused_step(..., n_steps=k)` and `cuda_fused_step_pipelined(...,
    n_steps=k)` on CPU tensors: events (k, B) and state equal k single calls
    bit for bit, and equal mptpu's Pallas step kernel looped in interpret
    mode on the same planted state (events identical, values rtol 1e-4 /
    atol 1e-5, residual rtol 1e-3 / atol 1e-5, map and table rtol 1e-4 /
    atol 1e-4), with a clipped event among them. The pipelined kernels take
    the lane-padded table, the one-block kernels the plain one."""
    step, j_step, padded = STEP_KERNELS[kernel]
    k = 7
    arrays, geom = encode_state_np(3)
    if not padded:
        arrays[1] = np.ascontiguousarray(arrays[1][..., : geom.n_blocks])
    kw = geom._asdict()
    kernels.reset_launches()

    chain = [torch.from_numpy(a.copy()) for a in arrays]
    ev = step(*chain, gate_tail=gate_tail, n_steps=k, **kw)
    assert ev.atoms.shape == ev.positions.shape == ev.values.shape == (k, 3)
    assert ev.atoms.dtype == ev.positions.dtype == torch.int32
    assert (ev.positions > 1024 - 128).any()

    single = [torch.from_numpy(a.copy()) for a in arrays]
    one_by_one = [step(*single, gate_tail=gate_tail, **kw) for _ in range(k)]
    assert one_by_one[0].atoms.shape == (3,)
    for field in range(3):
        assert torch.equal(ev[field], torch.stack([e[field] for e in one_by_one]))
    for a, b in zip(chain[:3], single[:3]):
        assert torch.equal(a, b)

    jf, jb, jr = (jnp.asarray(a) for a in arrays[:3])
    jd, jg = jnp.asarray(arrays[3]), jnp.asarray(arrays[4])
    j_events = []
    for _ in range(k):
        jf, jb, jr, ja, jp, jv = j_step(jf, jb, jr, jd, jg, gate_tail=gate_tail, interpret=True,
                                        **kw)
        j_events.append((ja, jp, jv))
    np.testing.assert_array_equal(ev.atoms.numpy(), np.stack([np.asarray(e[0]) for e in j_events]))
    np.testing.assert_array_equal(ev.positions.numpy(),
                                  np.stack([np.asarray(e[1]) for e in j_events]))
    np.testing.assert_allclose(ev.values.numpy(), np.stack([np.asarray(e[2]) for e in j_events]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(chain[2].numpy(), np.asarray(jr), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(chain[0].numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(chain[1].numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("kernel", list(STEP_KERNELS))
def test_step_wrappers_refuse_bad_n_steps(kernel):
    arrays, geom = encode_state_np(2)
    with pytest.raises(ValueError, match="n_steps"):
        STEP_KERNELS[kernel][0](*(torch.from_numpy(a) for a in arrays), n_steps=0,
                                **geom._asdict())


@pytest.mark.parametrize("cluster", [0, 3, 32])
def test_fused_step_pipelined_refuses_a_bad_cluster(cluster):
    """1, 2, 4, 8 or 16 blocks per item, and a divisor of the atoms (16
    here), on CPU tensors too."""
    arrays, geom = encode_state_np(2)
    with pytest.raises(ValueError, match="cluster"):
        tsp.cuda_fused_step_pipelined(*(torch.from_numpy(a) for a in arrays), cluster=cluster,
                                      **geom._asdict())


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "one_block"])
def test_sparse_code_fast_makes_one_step_call_per_encode(pipelined, monkeypatch):
    """The fused per-step engine hands all n_steps to one call of the step
    wrapper (no Python loop over steps), and its result still equals
    mptpu's."""
    from mptpu_torch.sparse import fast_mp

    name = "cuda_fused_step_pipelined" if pipelined else "cuda_fused_step"
    calls = []
    real = getattr(fast_mp, name)

    def counted(*args, **kw):
        calls.append(kw.get("n_steps"))
        return real(*args, **kw)

    monkeypatch.setattr(fast_mp, name, counted)
    sig = planted(D16, 3, 1024)
    j, t = run_both(D16, sig, 9, block=128, fused=True, pipelined=pipelined)
    assert calls == [9]
    assert_same(j, t)


@pytest.mark.parametrize("n_steps,want", [(None, 1), (1, 1), (7, 7)])
def test_launch_step_counts_the_chain_it_was_told(n_steps, want, monkeypatch):
    """What a chain adds to `kernels.LAUNCHES` is the number of launches the
    wrapper asked the C entry for, and the scratch of the rows' maxima goes
    with it (the launcher itself is stood in for: no card here)."""
    from mptpu_torch.sparse import cuda_fused_mp

    seen = {}

    def launch(name, counter, *args, count=1):
        seen.update(name=name, counter=counter, count=count, n_pointers=sum(
            isinstance(a, int) and a > 2**20 for a in args), steps=args[-2])

    monkeypatch.setattr(cuda_fused_mp.kernels, "check", lambda *a, **k: None)
    monkeypatch.setattr(cuda_fused_mp.kernels, "launch", launch)
    arrays, geom = encode_state_np(2)
    tensors = [torch.from_numpy(a) for a in arrays]
    ev = cuda_fused_mp._launch_step(
        "mp_fused_step", "cuda_fused_step", *tensors, (2,) if n_steps is None else (n_steps, 2),
        True, geom._asdict(), n_steps or 1, 1, chain=n_steps or 1)
    assert seen["count"] == want and seen["steps"] == want
    assert seen["n_pointers"] == 10   # fm, bm, residual, d2, gram_p, tail, rows, 3 event arrays
    assert ev.atoms.shape == ((2,) if n_steps is None else (n_steps, 2))
