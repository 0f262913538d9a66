"""The energy instrument, its overfit and the two trainers (ROADMAP A9a) in
the port against ``mptpu`` on JAX-CPU: ``gen/energy.py``,
``models/energy_overfit.py`` (three steps against ``scripts/energy_overfit.py``'s
jitted step at ``--tiny``, restated here from its lines, which live inside
its ``main``), ``train/runner.py`` and ``train/gan.py``; and the rehearsal
of ``chip_smoke.py``'s phase 13.

``mptpu``'s flax trees are carried by ``convert.module_from_flax``; every
JAX call is jitted.

Tolerances: forwards rtol 1e-5 / atol 1e-6 of their peak; gradients within
1e-4 of each leaf's largest; an Adam step's loss rtol 1e-5 and its
parameters within 1e-3 of the learning rate of optax's, where a gradient
entry stands above 1e-3 of its leaf's largest (below, Adam's first step
``g / (|g| + 1e-8)`` follows the entry's rounding: those are held within
two learning rates). The overfit's steps are held in float64 (losses rtol
1e-9, gradients 1e-8 of their largest): its l1 spectral loss makes float32
gradients noise at 1e-4 to 1e-3 of their largest in both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.gen import energy as jen
from mptpu.losses.gan import least_squares_disc_loss as j_disc_loss
from mptpu.nn import DownsamplingDiscriminator as JDisc
from mptpu.ops.stft import stft as j_stft
from mptpu.train import runner as jrunner
from mptpu.train.gan import gan_cycle as j_gan_cycle
from mptpu.train.gan import make_gan_steps as j_make_gan_steps
from mptpu_torch import convert
from mptpu_torch.data.synthetic import synthetic_audio
from mptpu_torch.gen import energy
from mptpu_torch.models import energy_overfit as teo
from mptpu_torch.nn.unet import DownsamplingDiscriminator
from mptpu_torch.obs.collection import Collection
from mptpu_torch.train import gan, runner
from mptpu_torch.train.optim import Adam

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work (the suite may run in
    six test processes on one machine)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def close_to_peak(port, want):
    want = np.asarray(want)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(port, want, rtol=FWD["rtol"], atol=FWD["atol"] * np.abs(want).max())


def leaf_close(port, want, where=""):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(port - want).max() <= GRAD * scale, (
        f"{where}: {np.abs(port - want).max() / scale:.2e} of the largest")


def port_grads(module, loss):
    """The gradients of ``loss`` laid out as the module's flax tree."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(g)
        tree = convert.module_to_flax(module)["params"]
        for p, s in zip(params, saved):
            p.copy_(s)
    return tree


def trees_close(port, want):
    port, want = flat(port), flat(want)
    assert set(port) == set(want)
    for k in want:
        leaf_close(port[k], want[k], k)


def step_close(got, want, grads, lr, where=""):
    """Parameters after one Adam step: within 1e-3 lr where the gradient
    entry stands above 1e-3 of its leaf's largest, within 2 lr elsewhere."""
    got, want, grads = (np.asarray(a, np.float64) for a in (got, want, grads))
    decided = np.abs(grads) > 1e-3 * np.abs(grads).max()
    err = np.abs(got - want)
    assert err[decided].max(initial=0) <= 1e-3 * lr, where
    assert err.max() <= 2 * lr, where


# ---- gen/energy.py


def test_blocks_and_discontinuity():
    x = rand(2, 3, 64, seed=1)
    b = energy.to_blocks(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jen.to_blocks(jnp.asarray(x), 16)))
    np.testing.assert_array_equal(energy.blocks_to_samples(b).numpy(), x)
    # a continuous boundary sits on the kink: jnp.abs's gradient there is +1
    x[0, 0, 16] = x[0, 0, 15]
    xt = torch.from_numpy(x).requires_grad_()
    d = energy.compute_discontinuity(energy.to_blocks(xt, 16))
    (g,) = torch.autograd.grad(d, [xt])
    jd, jg = jax.value_and_grad(lambda a: jen.compute_discontinuity(jen.to_blocks(a, 16)))(
        jnp.asarray(x))
    np.testing.assert_allclose(float(d), float(jd), rtol=1e-6)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("time", [16, 40], ids=["within", "past_line"])
def test_energy_block(time):
    """Past ``line_len`` blocks the decay line is exactly 0, where the
    exponent's gradient must be 0 in both packages."""
    jm = jen.EnergyBlock(channels=8, line_len=24)
    x = rand(2, time, 8, seed=2)
    params = jax.jit(jm.init)(KEY, x)
    tm = convert.module_from_flax(energy.EnergyBlock(8, line_len=24, device="cpu"), params)
    cot = rand(2, time, 8, seed=3)
    want = jax.jit(jm.apply)(params, x)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, x) * cot)))(params)["params"]
    got = tm(torch.from_numpy(x))
    close_to_peak(got, want)
    tg = port_grads(tm, torch.sum(got * torch.from_numpy(cot)))
    assert np.isfinite(flat(tg)["['pow']"]).all()
    trees_close(tg, jgrad)


def test_energy_instrument_model():
    jm = jen.EnergyInstrumentModel(input_channels=2, model_channels=16, block_size=32, n_layers=2)
    x = rand(1, 2, 1024, seed=4, scale=0.1)
    params = jax.jit(jm.init)(KEY, x)
    tm = convert.module_from_flax(energy.EnergyInstrumentModel(2, 16, 32, 2, device="cpu"), params)
    assert sorted(flat(convert.module_to_flax(tm)["params"])) == sorted(flat(params["params"]))
    cot = rand(1, 1, 1024, seed=5)
    want = jax.jit(jm.apply)(params, x)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, x) * cot)))(params)["params"]
    got = tm(torch.from_numpy(x))
    close_to_peak(got, want)
    trees_close(port_grads(tm, torch.sum(got * torch.from_numpy(cot))), jgrad)


# ---- models/energy_overfit.py


def script_step(n, block, channels, layers, target):
    """scripts/energy_overfit.py's model, loss and jitted step (:54-82)."""
    jm = jen.EnergyInstrumentModel(input_channels=1, model_channels=channels, block_size=block,
                                   n_layers=layers)
    sites = np.linspace(0, n - block, 16).astype(int)
    opt = optax.adam(1e-3)

    def loss_fn(state):
        ctrl = jnp.zeros((1, 1, n), state["amps"].dtype)
        recon = jm.apply(state["model"], ctrl.at[0, 0, jnp.asarray(sites)].set(state["amps"]))
        spec_l = jnp.abs(j_stft(recon, 2048, 256, pad=True)
                         - j_stft(target, 2048, 256, pad=True)).sum()
        disc = jen.compute_discontinuity(jen.to_blocks(recon, block))
        return spec_l + 0.1 * disc

    @jax.jit
    def step(state, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(state)
        updates, opt_state = opt.update(grads, opt_state, state)
        return optax.apply_updates(state, updates), opt_state, loss, grads

    return jm, opt, step, jax.jit(loss_fn)


def test_energy_overfit_state_matches_the_scripts():
    n, block, channels, layers = teo.TINY
    state = teo.EnergyOverfit(n, block, channels, layers, device="cpu")
    np.testing.assert_array_equal(state.sites.numpy(),
                                  np.linspace(0, n - block, 16).astype(int))
    ctrl = state.control().detach().numpy()
    assert ctrl.shape == (1, 1, n) and np.count_nonzero(ctrl) == 16
    np.testing.assert_allclose(ctrl[0, 0, state.sites.numpy()], 0.1)
    # the leaves in the order of mptpu's state tree: amps, then the model's flax paths
    paths = convert.flax_paths(state.model)
    names = {id(p): k for k, p in state.model.named_parameters()}
    order = [paths[names[id(p)]] for p in state.leaves()[1:]]
    assert state.leaves()[0] is state.amps and order == sorted(order)


def test_three_energy_steps_against_the_scripts_at_tiny():
    """The float32 loss at mptpu's init, then three steps of both in float64
    (``jax.enable_x64``), each from the state the one before left: the l1
    of two spectral magnitudes flips sign on part of its residual between
    roundings, so its float32 gradients are noise at 1e-4 to 1e-3 of their
    largest in both packages (the amplitudes' 2.6e-4 here). Float64:
    losses rtol 1e-9, gradients within 1e-8 of each leaf's largest,
    parameters as ``step_close``."""
    n, block, channels, layers = teo.TINY
    seg = synthetic_audio(n, 22050, n_events=4, seed=5)
    target = torch.from_numpy(seg).reshape(1, 1, -1)
    jm, opt, step, j_loss = script_step(n, block, channels, layers, jnp.asarray(target.numpy()))
    tm = teo.EnergyOverfit(n, block, channels, layers, device="cpu")
    params = jax.jit(jm.init)(KEY, jnp.zeros((1, 1, n)))
    convert.module_from_flax(tm.model, params)
    state = {"model": params, "amps": jnp.ones((16,)) * 0.1}
    np.testing.assert_allclose(float(teo.EnergyLoss(target, block)(tm())[0]),
                               float(j_loss(state)), rtol=1e-5)

    tm.double()
    adam = Adam(1e-3)
    t_opt = adam.init(tm.leaves())
    loss_fn = teo.EnergyLoss(target.double(), block)
    with jax.enable_x64(True):
        jm, opt, step, _ = script_step(n, block, channels, layers,
                                       jnp.asarray(target.numpy(), jnp.float64))
        state = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), state)
        opt_state = opt.init(state)
        for i in range(3):
            grads = torch.autograd.grad(loss_fn(tm())[0], tm.leaves())
            loss, _, _, t_opt = teo.energy_step(tm, adam, t_opt, loss_fn)
            state, opt_state, j_loss, j_grads = step(state, opt_state)
            np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-9, err_msg=f"step {i}")
            assert np.abs(grads[0].numpy() - np.asarray(j_grads["amps"])).max() <= (
                1e-8 * np.abs(np.asarray(j_grads["amps"])).max()), f"step {i} amps gradient"
            step_close(tm.amps.detach().numpy(), state["amps"], j_grads["amps"], 1e-3,
                       f"step {i}")
            got = flat(convert.module_to_flax(tm.model)["params"])
            want, jg = flat(state["model"]["params"]), flat(j_grads["model"]["params"])
            for k in want:
                step_close(got[k], want[k], jg[k], 1e-3, f"step {i} {k}")


def test_overfit_energy_entry_point_logs_as_the_script():
    n = teo.TINY[0]
    lines = []
    run = teo.overfit_energy(iterations=3, tiny=True,
                             target=torch.from_numpy(synthetic_audio(n, 22050, n_events=4, seed=5)),
                             device="cpu", log=lines.append)
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert lines[0].startswith("iter 0 loss ") and lines[-1].startswith("done: 3 iters in ")


# ---- train/runner.py


def linear_step(lr):
    """A least-squares step on (w,): loss, the new w, the recon; the same
    function on jnp and on torch tensors."""
    def step(w, opt_state, batch, key):
        x, y = batch[0], batch[1]
        recon = x * w
        loss = ((recon - y) ** 2).mean()
        grad = (2 * (recon - y) * x).mean()
        return w - lr * grad, opt_state + 1, loss, recon
    return step


def test_experiment_runner_against_mptpus(tmp_path):
    """The same step over the same stream: the same losses, checkpoints
    at the same steps, ``resume`` back to the newest one; ``real`` and
    ``fake`` logged by assignment."""
    rng = np.random.default_rng(0)
    stream = [(rng.standard_normal(8).astype(np.float32),) * 1 for _ in range(7)]
    stream = [(x, 3 * x) for (x,) in stream]
    jr = jrunner.BaseExperimentRunner(
        [tuple(jnp.asarray(a) for a in b) for b in stream], linear_step(0.1), jnp.float32(0.0), 0,
        checkpoint_dir=str(tmp_path / "j"), checkpoint_every=3)
    jr.run()
    coll = Collection(str(tmp_path / "kv"))
    tr = runner.BaseExperimentRunner(
        [tuple(torch.from_numpy(a) for a in b) for b in stream], linear_step(0.1),
        torch.tensor(0.0), 0, checkpoint_dir=str(tmp_path / "t"), checkpoint_every=3,
        collection=coll, device="cpu")
    tr.run(max_iterations=5)
    np.testing.assert_allclose(tr.losses, jr.losses[:5], rtol=1e-6)
    assert {"loss", "real", "fake"} <= set(coll.names())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "ckpt_000000000.pkl", "ckpt_000000003.pkl"]
    again = runner.BaseExperimentRunner([], linear_step(0.1), torch.tensor(9.0), None,
                                        checkpoint_dir=str(tmp_path / "t"), device="cpu")
    assert again.resume() == 3 and again.opt_state == 4
    np.testing.assert_allclose(float(again.params), float(jr.losses and jr.params) * 0 +
                               float(_param_after(stream, 4)), rtol=1e-6)


def _param_after(stream, k):
    w = np.float32(0.0)
    for x, y in stream[:k]:
        w = w - np.float32(0.1) * np.mean(2 * (x * w - y) * x)
    return w


def test_experiment_runner_keys():
    """Iteration i's generator is seeded from (seed, i): the same draws
    on every run, others on other iterations; ``draws`` replaces it."""
    r = runner.BaseExperimentRunner([], None, None, None, checkpoint_dir="unused", device="cpu")
    a, b, c = (torch.rand(4, generator=r.key(i)) for i in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    r.draws = lambda i: i * 10
    assert r.key(3) == 30


# ---- train/gan.py


def test_gan_cycle():
    from itertools import islice
    assert list(islice(gan.gan_cycle(), 5)) == list(islice(j_gan_cycle(), 5))


def test_lazy_exports_of_losses():
    import mptpu_torch.losses as losses

    assert losses.make_gan_steps is gan.make_gan_steps and losses.gan_cycle is gan.gan_cycle


def test_gan_steps_against_mptpus():
    """One generator step and one discriminator step, each from the same
    parameters: the losses, the gradients (optax's first moment after one
    step is 0.1 of the gradient) and the new parameters. The generator is
    an energy instrument over a fixed control signal, the discriminator
    ``DownsamplingDiscriminator``; each step differentiates its own
    player's parameters only."""
    n = 2**11
    jg = jen.EnergyInstrumentModel(input_channels=1, model_channels=8, block_size=64, n_layers=1)
    jd = JDisc(window_size=256, step_size=128, n_samples=n, channels=16)
    ctrl = rand(1, 1, n, seed=6)
    batch = rand(1, 1, n, seed=7, scale=0.1)
    gp = jax.jit(jg.init)(KEY, ctrl)
    dp = jax.jit(jd.init)(jax.random.PRNGKey(7), batch)
    # scale the generator up so that the discriminator sees it
    gp = jax.tree_util.tree_map(lambda a: a * 4.0, gp)
    g_opt, d_opt = optax.adam(1e-4), optax.adam(1e-4)
    train_gen, train_disc = j_make_gan_steps(
        lambda p, b, k: jg.apply(p, jnp.asarray(ctrl) * 20), jd.apply, g_opt, d_opt)
    gp2, gs, gl = train_gen(gp, g_opt.init(gp), dp, jnp.asarray(batch), KEY)
    dp2, ds, dl = train_disc(dp, d_opt.init(dp), gp, jnp.asarray(batch), KEY)
    assert float(dl) == pytest.approx(float(j_disc_loss(
        jd.apply(dp, jnp.asarray(batch)), jd.apply(dp, jg.apply(gp, jnp.asarray(ctrl) * 20)))))

    tg = convert.module_from_flax(energy.EnergyInstrumentModel(1, 8, 64, 1, device="cpu"), gp)
    td = convert.module_from_flax(DownsamplingDiscriminator(256, 128, n, 16, device="cpu"), dp)
    ctrl_t = torch.from_numpy(ctrl) * 20

    def gen_apply(p, b, key):
        return torch.func.functional_call(tg, p, (ctrl_t,))

    def disc_apply(p, x):
        return torch.func.functional_call(td, p, (x,))

    t_gen, t_disc = gan.make_gan_steps(gen_apply, disc_apply, Adam(1e-4), Adam(1e-4))
    tgp, tdp = dict(tg.named_parameters()), dict(td.named_parameters())
    before = {k: v.detach().clone() for k, v in {**tgp, **tdp}.items()}
    tgp2, tgs, tgl = t_gen(tgp, Adam(1e-4).init(list(tgp.values())), tdp, torch.from_numpy(batch),
                           None)
    tdp2, tds, tdl = t_disc(tdp, Adam(1e-4).init(list(tdp.values())), tgp,
                           torch.from_numpy(batch), None)
    for k, v in {**tgp, **tdp}.items():   # the steps changed no input in place
        assert torch.equal(v.detach(), before[k]), k
    np.testing.assert_allclose(float(tgl), float(gl), rtol=1e-5)
    np.testing.assert_allclose(float(tdl), float(dl), rtol=1e-5)
    for module, new, state, j_new, j_state in ((tg, tgp2, tgs, gp2, gs), (td, tdp2, tds, dp2, ds)):
        paths = convert.flax_paths(module)
        j_mu = flat(j_state[0].mu["params"])
        j_p = flat(j_new["params"])
        for (name, p), mu in zip(new.items(), state.mu):
            key = "".join(f"['{s}']" for s in paths[name])
            t_mu = mu.numpy()
            if "kernel" in key and module is td and mu.ndim == 3:   # Conv (out, in, k)
                t_mu, p = t_mu.transpose(2, 1, 0), p.permute(2, 1, 0)
            elif "kernel" in key:
                t_mu, p = t_mu.T, p.T
            leaf_close(t_mu, j_mu[key], key)
            step_close(p.numpy(), j_p[key], j_mu[key], 1e-4, key)


# ---- chip_smoke.py's phase 13


def test_phase_13_rehearsal_on_the_cpu():
    """chip_smoke.py's phase 13 at its rehearsal sizes on the CPU, where
    the card's side is the CPU too: every gate it runs on a card runs here,
    the energy trajectory against mptpu's recorded at --tiny."""
    import chip_smoke

    chip_smoke.zoo_phase(torch.device("cpu"), chip_smoke.ZOO_SMALL, lambda: None)
