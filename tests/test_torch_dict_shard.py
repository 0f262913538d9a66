"""mptpu_torch.parallel (make_mesh, sharded_mp_correlate,
sharded_sparse_code) on 2 and 2 x 2 ranks of ``torch.distributed``'s gloo
backend on the CPU, against the port's naive ``sparse_code`` and mptpu's
``sharded_sparse_code`` on the 8-device virtual CPU mesh.

Each group of ranks is started once for the module (``spawn``), meets
through a ``FileStore`` under a temporary directory (no ports to collide
under xdist) and writes its results to a file there; every rank is joined
with a deadline and killed past it, so that a hung collective fails the
tests instead of hanging them. This file imports no JAX at its top: the
ranks import it, and JAX is imported inside the tests.

Tolerances, as tests/test_parallel.py: events identical; values rtol 1e-4
/ atol 1e-5; residuals rtol 1e-3 / atol 1e-4. Signals are planted atom
sums, so that no near-tie flips an event between frameworks.
"""

import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mptpu_torch import sparse as tsp
from mptpu_torch.parallel import make_mesh, sharded_mp_correlate, sharded_sparse_code

DEADLINE_S = 120
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
RESIDUAL_TOL = dict(rtol=1e-3, atol=1e-4)


def planted(n_atoms, atom_size, batch, n_samples, seed, tie_shard=None):
    """(dictionary, signal): per item six unit atoms with falling
    amplitudes. With ``tie_shard``, atoms ``i`` and ``i + tie_shard`` are
    equal, so that every winner ties across two shards."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_atoms, atom_size)).astype(np.float32)
    if tie_shard is not None:
        d[tie_shard:] = d[:tie_shard]
    du = d / np.linalg.norm(d, axis=-1, keepdims=True)
    sig = np.zeros((batch, 1, n_samples), np.float32)
    for b in range(batch):
        for k in range(6):
            pos = int(rng.integers(0, n_samples - atom_size))
            sig[b, 0, pos : pos + atom_size] += du[int(rng.integers(n_atoms))] * 4.0 * 0.8**k
    return d, sig


# the cases each group of ranks runs: name -> (dictionary, signal, kwargs)
TWO_RANK_CASES = {
    "dict": (*planted(16, 8, 2, 64, seed=0), dict(n_steps=4)),
    "ties": (*planted(16, 8, 2, 64, seed=1, tie_shard=8), dict(n_steps=4)),
    "indivisible": (*planted(3, 8, 1, 64, seed=2), dict(n_steps=2)),
    "indivisible_batch": (*planted(16, 8, 3, 64, seed=3), dict(n_steps=2, data_axis="dict")),
}
FOUR_RANK_CASES = {
    "data_dict": (*planted(16, 8, 4, 64, seed=3), dict(n_steps=4, data_axis="data")),
}


def _rank_main(rank, world, root, axis_sizes, axis_names, cases):
    """One rank: every case through sharded_sparse_code (and, without a
    data axis, sharded_mp_correlate), the result or the raised error
    pickled to ``root/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    results = {}
    try:
        store = dist.FileStore(f"{root}/store", world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        mesh = make_mesh(axis_sizes, axis_names, device="cpu")
        for name, (d, sig, kw) in cases.items():
            try:
                out = sharded_sparse_code(mesh, torch.from_numpy(sig), torch.from_numpy(d), **kw)
                results[name] = ("ok", tuple(x.numpy() for x in out))
                if "data_axis" not in kw:
                    corr = sharded_mp_correlate(mesh, torch.from_numpy(sig), torch.from_numpy(d))
                    results[name + "_corr"] = ("ok", corr.numpy())
            except ValueError as e:
                results[name] = ("raised", str(e))
        try:
            make_mesh((world + 1,), ("dict",), device="cpu")
        except ValueError as e:
            results["mesh_too_big"] = ("raised", str(e))
        dist.destroy_process_group()
    except Exception:   # reported to the test, which fails on it
        results["error"] = ("error", traceback.format_exc())
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def run_ranks(root, axis_sizes, axis_names, cases):
    world = int(np.prod(axis_sizes))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(root), axis_sizes, axis_names,
                                                  cases))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            pytest.fail(f"ranks {hung} of {world} still running after {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    results = []
    for r in range(world):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
        assert "error" not in results[-1], results[-1]["error"][1]
    return results


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("two_ranks"), (2,), ("dict",), TWO_RANK_CASES)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("four_ranks"), (2, 2), ("data", "dict"),
                     FOUR_RANK_CASES)


def assert_matches(got, ref):
    atoms, positions, values, residual = got
    np.testing.assert_array_equal(atoms, np.asarray(ref.atom_indices))
    np.testing.assert_array_equal(positions, np.asarray(ref.positions))
    np.testing.assert_allclose(values, np.asarray(ref.values), **VALUE_TOL)
    np.testing.assert_allclose(residual, np.asarray(ref.residual), **RESIDUAL_TOL)


def mptpu_sharded(d, sig, axis_sizes, axis_names, **kw):
    import jax.numpy as jnp
    from mptpu.parallel import make_mesh as j_make_mesh
    from mptpu.parallel import sharded_sparse_code as j_sharded

    mesh = j_make_mesh(axis_sizes=axis_sizes, axis_names=axis_names)
    return j_sharded(mesh, jnp.asarray(sig), jnp.asarray(d), **kw)


def check_case(results, name, axis_sizes, axis_names):
    d, sig, kw = (TWO_RANK_CASES | FOUR_RANK_CASES)[name]
    naive = tsp.sparse_code(torch.from_numpy(sig), torch.from_numpy(d), n_steps=kw["n_steps"])
    j_out = mptpu_sharded(d, sig, axis_sizes, axis_names, **kw)
    for res in results:   # the global result on every rank
        status, got = res[name]
        assert status == "ok", got
        assert got[0].dtype == np.int32 and got[1].dtype == np.int32
        assert_matches(got, naive)
        assert_matches(got, j_out)
    return naive


def test_dictionary_sharded_mp_matches_single_device(two_ranks):
    """tests/test_parallel.py:25 on two gloo ranks; the correlation shards
    together are mptpu's sharded map."""
    import jax.numpy as jnp
    from mptpu.parallel import make_mesh as j_make_mesh
    from mptpu.parallel import sharded_mp_correlate as j_corr

    check_case(two_ranks, "dict", (2,), ("dict",))
    d, sig, _ = TWO_RANK_CASES["dict"]
    want = np.asarray(j_corr(j_make_mesh(axis_sizes=(2,), axis_names=("dict",)),
                             jnp.asarray(sig), jnp.asarray(d)))
    got = np.concatenate([res["dict_corr"][1] for res in two_ranks], axis=1)
    np.testing.assert_allclose(got, want, **VALUE_TOL)


def test_ties_go_to_the_lower_global_atom(two_ranks):
    """Shard 1 holds a copy of shard 0: every winner ties across the two
    shards and must come from shard 0, as the naive argmax's first index."""
    naive = check_case(two_ranks, "ties", (2,), ("dict",))
    assert int(naive.atom_indices.max()) < 8


def test_dictionary_sharded_mp_2d_mesh_matches_single_device(four_ranks):
    """tests/test_parallel.py:72 on 2 x 2 gloo ranks, (data, dict)."""
    check_case(four_ranks, "data_dict", (2, 2), ("data", "dict"))


@pytest.mark.parametrize("name,match", [("indivisible", "n_atoms .3. must be divisible"),
                                        ("indivisible_batch", "batch .3. must be divisible")])
def test_sharded_sparse_code_rejects_indivisible_shapes(two_ranks, name, match):
    """tests/test_parallel.py:112 (3 atoms on 2 ranks), and a batch of 3 on
    a data axis of 2: the same ValueError on every rank as in mptpu."""
    import re

    d, sig, kw = TWO_RANK_CASES[name]
    with pytest.raises(ValueError, match=match) as j_err:
        mptpu_sharded(d, sig, (2,), ("dict",), **kw)
    for res in two_ranks:
        status, msg = res[name]
        assert status == "raised" and re.search(match, msg), msg
        assert msg == str(j_err.value)


def test_make_mesh_needs_the_world_size(two_ranks):
    for res in two_ranks:
        status, msg = res["mesh_too_big"]
        assert status == "raised" and "needs 3 devices" in msg


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
