"""Data-parallel SIAM training (``scripts/train_siam.py``'s step through
``parallel.make_data_parallel_step``) on 2 ranks of ``torch.distributed``'s
gloo backend on the CPU, against one process on the whole batch and
against ``mptpu``'s ``make_data_parallel_step`` on 2 devices of the
virtual CPU mesh; ``shard_batch``; and ``train_and_monitor`` at
``--tiny``'s size on the demo corpus: the dashboard, the checkpoints,
``--load-weights``.

The ranks are started once for the module (``spawn``), meet through a
``FileStore`` under a temporary directory and write their results there;
they are joined with a deadline and killed past it. This file imports no
JAX at its top: the ranks import it.

Tolerances: losses rtol 1e-6 between the port's runs (the same sums in
another order) and 1e-5 against ``mptpu``; Adam's moments within 1e-4 of
each leaf's largest (the float32 gradients' noise, 1.6e-5 measured in
``tests/test_torch_siam_train.py``);
the parameters within 1e-6 in at least 95% of their entries and
everywhere within twice the learning rate a step (Adam takes the float32
noise of a gradient entry near zero to a full step either way; see
``tests/test_torch_siam_train.py``).
"""

import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mptpu_torch import convert
from mptpu_torch.data import synthetic as tsyn
from mptpu_torch.models import siam as ts
from mptpu_torch.models.siam_overfit import parameters_swapped
from mptpu_torch.models.siam_train import siam_train_loss, train_and_monitor
from mptpu_torch.parallel import make_data_parallel_step, make_mesh, shard_batch
from mptpu_torch.train.optim import Adam

DEADLINE_S = 120
N, E, BATCH, STEPS, LR = 2**13, 4, 2, 2, 1e-4
# scripts/train_siam.py:39-90 at --tiny, its defaults (switch clamp 100, residual clamp 4,
# encoder clamp 1e4)
CFG = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=E,
           transform_window_size=512, transform_step_size=256, fft_resonance=True,
           switch_clamp=100.0, residual_clamp_scale=4.0, encoder_clamp=1e4)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work: the tier-1 run puts
    six test processes on one machine, where PyTorch's default of a thread
    a core makes every process wait on descheduled threads."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def batch():
    """Two max-normalised synthetic segments (batch, 1, n)."""
    items = [tsyn.synthetic_audio(N, n_events=4, seed=s, sustained=True) for s in (3, 4)]
    return np.stack([x / np.abs(x).max() for x in items]).reshape(BATCH, 1, N).astype(np.float32)


def port_model():
    return ts.SIAMModel(**CFG, generator=torch.Generator().manual_seed(1), device="cpu")


def port_steps(mesh, noise):
    """STEPS guarded Adam steps of train_siam.py's loss through
    make_data_parallel_step; (losses, parameters, mu, nu as flax leaves,
    count)."""
    model = port_model()
    params = list(model.parameters())
    opt = Adam(lr=LR)
    state = opt.init(params)
    loss_fn = siam_train_loss(model, 512, 256)
    step = make_data_parallel_step(lambda x, nz: loss_fn(x, nz)[0], opt, mesh, batch_dims=(0, 1))
    losses = []
    for _ in range(STEPS):
        state, loss = step(params, state, torch.from_numpy(batch()), torch.from_numpy(noise))
        losses.append(float(loss))

    def tree(tensors):
        with parameters_swapped(model, tensors):
            return convert.module_to_flax(model)["params"]

    return losses, convert.module_to_flax(model)["params"], tree(state.mu), tree(state.nu), int(
        state.count)


def _rank_main(rank, world, root, noise):
    torch.set_num_threads(1)
    results = {}
    try:
        store = dist.FileStore(f"{root}/store", world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        mesh = make_mesh((world,), ("data",), device="cpu")
        results["steps"] = port_steps(mesh, noise)
        x = torch.arange(12.0).reshape(4, 3)
        results["shard"] = shard_batch(mesh, x).numpy()
        results["shard_dim1"] = shard_batch(mesh, x.T, dim=1).numpy()
        try:
            shard_batch(mesh, torch.zeros(3, 2))
        except ValueError as e:
            results["indivisible"] = str(e)
        dist.destroy_process_group()
    except Exception:   # reported to the test, which fails on it
        results["error"] = traceback.format_exc()
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def jax_noise():
    import jax

    key = jax.random.PRNGKey(42)
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (BATCH, 1, N),
                                                   minval=-1.0, maxval=1.0))
                     for i in range(E)])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("siam_dp")
    noise = jax_noise()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, str(root), noise)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            pytest.fail(f"ranks {hung} of 2 still running after {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    results = []
    for r in range(2):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
        assert "error" not in results[-1], results[-1]["error"]
    return results, noise


def flat(tree):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_moment_close(got, want, tol):
    for k, w in flat(want).items():
        g = flat(got)[k]
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), k


def assert_params_close(got, want, steps):
    g, w = flat(got), flat(want)
    far = 0
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= steps * 2 * LR * 1.1, k
        far += int((d > 1e-6).sum())
    assert far <= 0.05 * sum(v.size for v in w.values())


def test_two_ranks_equal_one_process_on_the_whole_batch(two_ranks):
    """The ranks' gradients are summed, not averaged: two steps on 2 ranks
    give one process's losses (the sum over both items), moments, count
    and parameters, and the two ranks hold the same parameters."""
    results, noise = two_ranks
    losses, params, mu, nu, count = results[0]["steps"]
    one = port_steps(None, noise)
    np.testing.assert_allclose(losses, one[0], rtol=1e-6)
    assert count == one[4] == STEPS
    assert_moment_close(mu, one[2], 1e-4)
    assert_moment_close(nu, one[3], 1e-4)
    assert_params_close(params, one[1], STEPS)
    for k, v in flat(results[1]["steps"][1]).items():
        np.testing.assert_array_equal(v, flat(params)[k])
    # a mean over the ranks would have halved the first moment
    big = max(flat(one[2]).items(), key=lambda kv: np.abs(kv[1]).max())[0]
    assert np.abs(flat(mu)[big]).max() > 0.9 * np.abs(flat(one[2])[big]).max()


def test_against_mptpus_data_parallel_step(two_ranks):
    """mptpu's make_data_parallel_step with train_siam.py's loss on 2
    devices of the virtual CPU mesh, from the same parameters and noise:
    losses within 1e-4 (each is a difference of spectral l1 norms that
    nearly cancel, 0.14 and -0.05 here, whose float32 sums differ in the
    seventh digit; measured 3.1e-5), moments within 1e-4 of each leaf's
    largest, parameters as the module states."""
    import jax
    import jax.numpy as jnp

    from mptpu.losses import iterative_loss
    from mptpu.models import siam as js
    from mptpu.parallel import make_data_parallel_step as j_dp_step, make_mesh as j_mesh
    from mptpu.train import optimizer

    results, _ = two_ranks
    losses, params, mu, nu, count = results[0]["steps"]
    jm = js.SIAMModel(**CFG)
    iterative = js.make_iterative_fn(jm)
    fade = js.fade_tail(N)

    def loss_fn(p, target, key):
        channels, _, _, _ = iterative(p, target, key)
        return iterative_loss(target * fade, channels,
                              lambda x: js.siam_transform(x, 512, 256, mag_epsilon=1e-6))

    opt = optimizer(lr=LR, b1=0.9, b2=0.999)
    mesh = j_mesh(axis_sizes=(2,), axis_names=("data",), devices=jax.devices()[:2])
    step = j_dp_step(loss_fn, opt, mesh)
    jp = jax.tree_util.tree_map(jnp.asarray, convert.module_to_flax(port_model()))
    jo = opt.init(jp)
    jl = []
    for _ in range(STEPS):
        jp, jo, loss = step(jp, jo, jnp.asarray(batch()), jax.random.PRNGKey(42))
        jl.append(float(loss))
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-4)
    assert int(jo[0].count) == count
    assert_moment_close(mu, jo[0].mu["params"], 1e-4)
    assert_moment_close(nu, jo[0].nu["params"], 1e-4)
    assert_params_close(params, jp["params"], STEPS)


def test_shard_batch(two_ranks):
    """Each rank holds its half of the rows, along any dimension; rows that
    do not divide over the ranks raise."""
    results, _ = two_ranks
    x = np.arange(12.0).reshape(4, 3)
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["shard"], x[2 * rank: 2 * rank + 2])
        np.testing.assert_array_equal(res["shard_dim1"], x.T[:, 2 * rank: 2 * rank + 2])
        assert "do not divide" in res["indivisible"]


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """The demo corpus under a temporary MPTPU_CACHE, the working directory
    a temporary one (the trainer's default paths are relative to it)."""
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_train_and_monitor_logs_checkpoints_and_resumes(corpus):
    """train_and_monitor at --tiny's size on the demo corpus, port 0: the
    losses finite, the dashboard's collection under the script's relative
    path with orig, recon and loss, a checkpoint at step 0 whose params
    mptpu loads and whose optimiser state is the port's layout, and
    load_weights resuming from it."""
    from mptpu.train import checkpoint as jckpt
    from mptpu_torch.obs import Collection

    out = train_and_monitor(batch_size=2, tiny=True, port=0, iterations=2, seed=0, log_every=1,
                            save_weights=True, device="cpu", log=lambda line: None)
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
    dash = Collection(os.path.join("trained_weights", "siam_dashboard"))
    assert dash.names() == ["loss", "orig", "recon"]
    assert dash.meta("orig")["kind"] == "audio" and dash.meta("loss")["count"] == 1
    ckpt = corpus / "trained_weights" / "siam" / "ckpt_000000000.pkl"
    payload = jckpt.load_checkpoint(str(ckpt))
    assert payload["step"] == 0 and payload["opt_state"]["count"] == 1
    assert set(payload["params"]) == {"params"}
    lines = []
    again = train_and_monitor(batch_size=2, tiny=True, port=0, iterations=2, seed=0,
                              load_weights=True, device="cpu", log=lines.append)
    assert lines[0] == "resumed from step 0" and len(again.losses) == 1
    assert out.reservoir.buffer.any()


def test_data_parallel_needs_a_process_group(corpus):
    with pytest.raises(RuntimeError, match="process group"):
        train_and_monitor(batch_size=2, tiny=True, port=0, iterations=1, data_parallel=True,
                          device="cpu", log=lambda line: None)
