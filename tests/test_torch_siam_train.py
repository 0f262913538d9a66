"""SIAM training (BASELINE #4) in the port against ``mptpu`` on JAX-CPU, at
``scripts/siam_overfit.py --tiny``'s size (2^13 samples, 4 events, hidden
32, context 16, STFT 512/256) under sw6's flags: the kink gradients of the
ops on the training path, the model's value and gradient with each model
flag on and off, the script's loss with and without the gain refit, its
stop-gradient and the gain regulariser, optax's Adam, the trust-ratio
clip, three train steps against a jitted transcription of the script's
``train_step``, the non-finite gate, ``StormGuard`` on every scenario of
``tests/test_storm_guard.py`` and on the trainer's non-rewinding loop
index, ``Reservoir``, ``random_sequence``, the eval metrics and
``module_to_flax``. ``mptpu``'s parameters are the port's seeded ones,
carried by ``convert.module_to_flax``; its noise (event ``i`` draws from
``fold_in(PRNGKey(42), i)``) is fed to the port as tensors. Every JAX
function is jitted.

Tolerances (each test names its own where it differs): frames identical;
loss rtol 1e-5; gradients within 1e-4 of each leaf's largest magnitude
(measured: 1.6e-5 to 1.9e-5; float32 rounding in sums taken in other
orders), 1e-3 after a step (``STEP_GRAD_TOL``). Adam normalises each entry by its own gradient, so an entry
whose gradient is near that noise floor moves by up to the learning rate
either way in either package: ``test_three_train_steps_against_the_scripts``
states how the parameters are held.
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import test_storm_guard as storm_scenarios
from mptpu.gen import transfer as jtransfer
from mptpu.losses import iterative_loss as j_iterative_loss
from mptpu.models import siam as js
from mptpu.nn import linear as jlinear
from mptpu.nn import pos_encode as jpe
from mptpu.ops import norms as jnorms
from mptpu.ops import ste as jste
from mptpu.perceptual import pif_distance as j_pif_distance
from mptpu.sparse import quantize as jq
from mptpu.train import optim as joptim
from mptpu.train.guard import StormGuard as JGuard
from mptpu_torch import convert
from mptpu_torch.data import synthetic as tsyn
from mptpu_torch.gen import transfer as ttransfer
from mptpu_torch.losses import iterative_loss as t_iterative_loss
from mptpu_torch.models import ssm_overfit as tssm
from mptpu_torch.models import siam as ts
from mptpu_torch.models import siam_overfit as tso
from mptpu_torch.nn import linear as tlinear
from mptpu_torch.nn import pos_encode as tpe
from mptpu_torch.ops import kinks
from mptpu_torch.ops import norms as tnorms
from mptpu_torch.ops import ste as tste
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.train import optim as toptim
from mptpu_torch.train.guard import StormGuard as TGuard

N, E, HALF = 2**13, 4, 2**12
WINDOW, STEP = 512, 256
KEY = jax.random.PRNGKey(42)
LR = 3e-4
# scripts/siam_overfit.py:347-349 (--tiny) with sw6's model flags (its metrics.json config)
CFG = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=E,
           transform_window_size=WINDOW, transform_step_size=STEP, fft_resonance=True,
           attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0, switch_clamp=20.0,
           residual_clamp_scale=4.0, encoder_clamp=1e4, vec_clamp=10.0)
GRAD_TOL = 1e-4
# the gradients' float32 noise follows the loss's scale, not the gradient's:
# after the first step the gradient norm falls from 26,756 to 2,204 and the
# noise does not, to 2.1e-4 of a leaf's largest with two CPU threads (5.9e-5
# with eight)
STEP_GRAD_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work: the tier-1 run puts
    six test processes on one machine, where PyTorch's default of a thread
    a core makes every process wait on descheduled threads."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module", autouse=True)
def knobs():
    """sw6's selection leak and floor (0.02) in both packages, set before
    any JAX function is traced and restored afterwards."""
    saved = [(m, m.RELU_SELECTION_LEAK, m.RELU_SELECTION_FLOOR) for m in (jq, tq)]
    for m in (jq, tq):
        m.set_selection_leak(0.02)
        m.set_selection_floor(0.02)
    yield
    for m, leak, floor in saved:
        m.set_selection_leak(leak)
        m.set_selection_floor(floor)


def jax_noise(n_events=E, key=KEY, batch=1):
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (batch, 1, N),
                                                   minval=-1.0, maxval=1.0))
                     for i in range(n_events)])


def inputs():
    """(faded input, target, first-half energy) of the tiny run's window,
    faded with mptpu's fade_tail."""
    tgt = tsyn.synthetic_audio(N, n_events=4, seed=3, sustained=True).reshape(1, 1, N)
    tgt = tgt.astype(np.float32)
    f_tgt = (tgt * np.asarray(js.fade_tail(N))).astype(np.float32)
    return f_tgt, tgt, np.float32(np.sum(tgt[..., :HALF] ** 2))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def port_model(seed=1, **overrides):
    return ts.SIAMModel(**dict(CFG, **overrides), generator=torch.Generator().manual_seed(seed),
                        device="cpu")


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(model, tensors):
    """``tensors`` (in the model's parameter order) as flax leaves."""
    with tso.parameters_swapped(model, list(tensors)):
        return leaves(convert.module_to_flax(model))


def assert_leaves_close(got, want, tol=GRAD_TOL, what=""):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= tol, f"{what} {k}: {err:.2e} of the largest"


def j_objective(channels, wave_w, f_tgt, tgt, tgt_e_half, gain_refit, gain_reg, stop_grad):
    """scripts/siam_overfit.py:482-517's loss_fn after the decomposition,
    with its refit_recon (:458-478)."""
    mag = j_iterative_loss(f_tgt, channels,
                           lambda x: js.siam_transform(x, WINDOW, STEP, mag_epsilon=1e-6))
    raw = jnp.sum(channels, axis=1, keepdims=True)
    recon, loss = raw, mag
    if gain_refit:
        gains = jnp.clip(js.refit_event_gains(tgt, channels, ridge=gain_refit, span=HALF),
                         -10.0, 10.0)
        if stop_grad:
            gains = jax.lax.stop_gradient(gains)
        recon = jnp.einsum("be,ben->bn", gains, channels)[:, None]
        if gain_reg:
            alive = jnp.sum(channels[..., :HALF] ** 2, axis=-1) > 1e-12
            loss = loss + gain_reg * jnp.sum(jnp.where(alive, (gains - 1.0) ** 2, 0.0)) / (
                jnp.maximum(jnp.sum(alive), 1))
    wave = jnp.sum((recon[..., :HALF] - tgt[..., :HALF]) ** 2) / jnp.maximum(tgt_e_half, 1e-12)
    return loss + wave_w * wave, (recon, wave, jax.lax.stop_gradient(raw[..., HALF:]))


def j_loss_fn(jm, gain_refit=1e-3, gain_reg=10.0, stop_grad=False):
    iterative = js.make_iterative_fn(jm)

    def loss_fn(params, key, wave_w, f_tgt, tgt, tgt_e_half):
        channels, _, schedules, _ = iterative(params, f_tgt, key)
        loss, aux = j_objective(channels, wave_w, f_tgt, tgt, tgt_e_half, gain_refit, gain_reg,
                                stop_grad)
        return loss, (aux, schedules)

    return loss_fn


# ---- step 0: the kinks -----------------------------------------------------------------------


def jgrad(fn, x):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v)))(jnp.asarray(x)))


def tgrad(fn, x):
    v = torch.tensor(np.asarray(x), requires_grad=True)
    (g,) = torch.autograd.grad(fn(v).sum(), v)
    return g.numpy()


DEAD_TARGET = np.asarray([[[1.0, 0.0, 2.0, -0.5]]], np.float32)
SILENCE = torch.zeros((1, 1, 1024))

KINKS = {
    # name: (mptpu's op, the port's op, inputs with an entry exactly at the kink)
    "leaky_relu_ste": (lambda x: jste.leaky_relu_ste(x, 0.1),
                       lambda x: tste.leaky_relu_ste(x, 0.1), [0.0, -1.0, 2.0]),
    "hard_choice_relu_leak": (lambda x: jq.hard_choice(x, "relu"),
                              lambda x: tq.hard_choice(x, "relu"), [0.0, -1.0, 2.0]),
    "linear_leaky_relu": (jlinear._leaky_relu, tlinear.leaky_relu, [0.0, -1.0, 2.0]),
    "pos_encode_clip": (lambda x: jpe.pos_encode_feature(x, 1.0, 2),
                        lambda x: tpe.pos_encode_feature(x, 1.0, 2), [[1.0], [-1.0], [0.5]]),
    "unit_norm_floor": (lambda x: jnorms.unit_norm(x, epsilon=0.5),
                        lambda x: tnorms.unit_norm(x, epsilon=0.5), [[0.5, 0.0], [1.0, 2.0]]),
    "limit_norm_cap": (lambda x: jnorms.limit_norm(x, axis=-1, max_norm_value=0.75),
                       lambda x: tnorms.limit_norm(x, axis=-1, max_norm_value=0.75),
                       [[0.75, 0.0], [0.1, 0.2]]),
    "oscillator_clip": (
        lambda x: jtransfer.damped_harmonic_oscillator(
            jnp.arange(4.0), 1.0, 0.0, x, 1.0, 0.0),
        lambda x: ttransfer.damped_harmonic_oscillator(
            torch.arange(4.0), torch.tensor(1.0), torch.tensor(0.0), x, torch.tensor(1.0), 0.0),
        [np.float32(1e-12)]),
    "clip": (lambda x: jnp.clip(x, -10.0, 10.0), lambda x: kinks.clip(x, -10.0, 10.0),
             [10.0, -10.0, 3.0, 11.0]),
    "abs": (jnp.abs, kinks.abs, [0.0, -0.0, 1.0, -1.0]),
    # the second channel renders exactly 0, and the first leaves residual
    # entries of exactly 0: each |residual| passes JAX's gradient there
    "iterative_loss_dead_channel": (
        lambda x: j_iterative_loss(jnp.asarray(DEAD_TARGET), x, lambda a: a),
        lambda x: t_iterative_loss(torch.from_numpy(DEAD_TARGET), x, lambda a: a),
        [[[1.0, 0.0, 0.0, -0.5], [0.0, 0.0, 0.0, 0.0]]]),
    # scripts/ssm_article.py:95-96 on silent audio, whose features equal
    # the target's: the boundary term's |0| passes JAX's gradient
    "ssm_loss_boundary": (
        lambda x: jnp.abs(x).sum() * 1.0,
        lambda x: tssm.ssm_loss(lambda: (SILENCE, x), tssm.transform(SILENCE)),
        [0.0, -0.0, 0.25, 0.0]),
}


@pytest.mark.parametrize("name", list(KINKS))
def test_kink_gradient_is_jaxs(name):
    """At the exact kink each op's gradient is jax.grad's: a leaky relu's
    is 1 at 0 (F.leaky_relu gives its slope), a clip's half at a bound
    (torch.clamp passes all of it), an abs's 1 at 0.0 and -0.0
    (torch.abs passes none)."""
    jfn, tfn, x = KINKS[name]
    x = np.asarray(x, np.float32)
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jfn(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tgrad(tfn, x), jgrad(jfn, x), rtol=1e-6, atol=1e-7)


# ---- step 1: the model's value and gradient under each flag ------------------------------------

# each model flag on and off across three configurations: sw6's, all four
# clamps and the leak off with the spectral skip on, and sw6's with the skip and
# the spectral filter
FLAGS = {
    "sw6": {},
    "no_clamps_skip": dict(attn_leak=0.0, switch_clamp=0.0, encoder_clamp=0.0, vec_clamp=0.0,
                           spectral_skip=True),
    "skip_filter": dict(spectral_skip=True, spectral_filter=True),
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_value_and_grad_under_each_flag(flags):
    """The script's whole loss (refit 1e-3, gain_reg 10, waveform weight
    2000) and its gradient with respect to every parameter, from one set
    of parameters and one noise draw: frames identical, loss rtol 1e-5,
    each leaf's gradient within 1e-4 of its largest."""
    tm = port_model(**FLAGS[flags])
    jm = js.SIAMModel(**dict(CFG, **FLAGS[flags]))
    params = jax.tree_util.tree_map(jnp.asarray, convert.module_to_flax(tm))
    f_tgt, tgt, tge = inputs()
    (jl, (_, jsched)), jg = jax.jit(jax.value_and_grad(j_loss_fn(jm), has_aux=True))(
        params, KEY, jnp.float32(2000.0), f_tgt, tgt, tge)
    trainer = tso.SIAMOverfitStep(tm, tso.LossSettings(WINDOW, STEP, 1e-3, 10.0))
    sched = ts.make_iterative_fn(tm)(t(f_tgt), t(jax_noise()))[2]
    np.testing.assert_array_equal(sched.argmax(-1).numpy(), np.asarray(jsched).argmax(-1))
    loss, _, grads = trainer.grads(t(jax_noise()), torch.tensor(2000.0), t(f_tgt), t(tgt),
                                   torch.tensor(tge))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert_leaves_close(port_leaves(tm, grads), leaves(jg), what="gradient")


# ---- the script's loss: refit on and off, its stop-gradient, the gain regulariser -------------

LOSSES = {
    "refit_off": dict(gain_refit=0.0, gain_reg=0.0, stop_grad=False),
    "refit": dict(gain_refit=1e-3, gain_reg=0.0, stop_grad=False),
    "refit_stop_grad": dict(gain_refit=1e-3, gain_reg=0.0, stop_grad=True),
    "refit_gain_reg": dict(gain_refit=1e-3, gain_reg=10.0, stop_grad=False),
}


@pytest.mark.parametrize("variant", list(LOSSES))
def test_overfit_objective(variant):
    """siam_overfit_objective of seeded channels (one of them dead, so that
    the regulariser's alive mask matters) against the script's loss_fn
    after the decomposition: value rtol 1e-5, recon, wave and raw tail, the
    gradient with respect to the channels within 1e-4 of its largest."""
    kw = LOSSES[variant]
    rng = np.random.default_rng(5)
    ch = (0.1 * rng.standard_normal((1, E, N))).astype(np.float32)
    ch[:, 2] = 0.0
    f_tgt, tgt, tge = inputs()
    jfn = jax.jit(jax.value_and_grad(functools.partial(j_objective, **kw), has_aux=True))
    (jl, (jrecon, jwave, jtail)), jg = jfn(ch, jnp.float32(2000.0), f_tgt, tgt, tge)
    settings = tso.LossSettings(WINDOW, STEP, kw["gain_refit"], kw["gain_reg"], kw["stop_grad"])
    c = torch.tensor(ch, requires_grad=True)
    loss, (recon, wave, tail) = tso.siam_overfit_objective(c, settings, torch.tensor(2000.0),
                                                           t(f_tgt), t(tgt), torch.tensor(tge))
    (g,) = torch.autograd.grad(loss, c)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(wave.detach()), float(jwave), rtol=1e-5)
    for got, want in ((recon, jrecon), (tail, jtail), (g, jg)):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= GRAD_TOL * np.abs(want).max()


# ---- step 2: optax's Adam and the trust-ratio clip ---------------------------------------------


def test_adam_update_is_optaxs():
    """Three updates of adam_update against optax.adam(3e-4, 0.9, 0.999)
    on seeded gradients: updates, moments rtol 1e-6, the count exact."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = optax.adam(LR, b1=0.9, b2=0.999)
    jstate = opt.init(params)
    tstate = toptim.adam_init([t(p) for p in params])
    for k in range(3):
        grads = [(rng.standard_normal(s) * 10.0**k).astype(np.float32) for s in shapes]
        jup, jstate = jax.jit(opt.update)(grads, jstate)
        tup, tstate = toptim.adam_update([t(g) for g in grads], tstate, LR)
        for got, want in zip(tup + tstate.mu + tstate.nu, list(jup) + list(jstate[0].mu)
                             + list(jstate[0].nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
        assert int(tstate.count) == int(jstate[0].count) == k + 1


def test_trust_ratio_clip_floor_on_zero_leaves():
    """trust_ratio_clip against mptpu's on zero-initialised leaves (the
    floor of 1e-3 sets their cap), a leaf within its cap and one over it."""
    rng = np.random.default_rng(1)
    params = [np.zeros(4, np.float32), np.zeros((2, 3), np.float32),
              rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)]
    updates = [np.full(4, 0.1, np.float32), rng.standard_normal((2, 3)).astype(np.float32),
               (1e-3 * rng.standard_normal(8)).astype(np.float32),
               (10.0 * rng.standard_normal(8)).astype(np.float32)]
    want, _ = jax.jit(joptim.trust_ratio_clip(0.1).update)(updates, optax.EmptyState(), params)
    got = toptim.trust_ratio_clip([t(u) for u in updates], [t(p) for p in params], 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # a zero leaf's update is capped at ratio * floor
    np.testing.assert_allclose(float(torch.linalg.vector_norm(got[0])), 0.1 * 1e-3, rtol=1e-5)


def test_lr_mult_halves_the_gradient_not_the_step():
    """Divergence kept from mptpu (ROADMAP C): rollback's lr halving scales
    the gradients fed to Adam, which normalises a lasting scale away. After
    200 steps of a constant gradient, 30 more at lr_mult 0.5 take steps
    under 0.6 of those at 1.0 (the second moment still holds the old
    scale), and after 5,000 the ratio is back above 0.95; optax and the
    port alike."""
    g = np.linspace(0.5, 2.0, 6).astype(np.float32)
    opt = optax.adam(LR, b1=0.9, b2=0.999)
    update = jax.jit(opt.update)

    def run(scale_after, steps_after):
        js_, ts_ = opt.init([g]), toptim.adam_init([t(g)])
        out = []
        for k in range(200 + steps_after):
            s = 1.0 if k < 200 else scale_after
            ju, js_ = update([g * s], js_)
            tu, ts_ = toptim.adam_update([t(g * s)], ts_, LR)
            out = (float(np.linalg.norm(np.asarray(ju[0]))), float(torch.linalg.vector_norm(tu[0])))
        return out

    short = [a / b for a, b in zip(run(0.5, 30), run(1.0, 30))]
    long = [a / b for a, b in zip(run(0.5, 5000), run(1.0, 5000))]
    for s in short:
        assert 0.5 <= s < 0.6
    for lo in long:
        assert lo > 0.95
    np.testing.assert_allclose(short[1], short[0], rtol=1e-4)


# ---- step 3: three train steps against the script's, and the gate -------------------------------


@pytest.fixture(scope="module")
def jstep():
    """scripts/siam_overfit.py:519-556's train_step under sw6's flags
    (refit 1e-3, gain_reg 10, EMA 0.999), jitted once: the trust ratio is
    an argument (1e30 is the clip off: min(1, ratio * |p| / |u|) = 1)."""
    jm = js.SIAMModel(**CFG)
    loss_fn = j_loss_fn(jm)
    opt = joptim.optimizer(lr=LR, b1=0.9, b2=0.999)

    def train_step(params, opt_state, ema, key, wave_w, clip, lr_mult, trust, f_tgt, tgt, tge):
        (loss, ((recon, wave, raw_tail), _)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, key, wave_w, f_tgt, tgt, tge)
        gnorm = optax.global_norm(grads)
        scale = lr_mult * jnp.minimum(1.0, clip / jnp.maximum(gnorm, 1e-12))
        grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
        updates, new_opt = opt.update(grads, opt_state, params)
        updates, _ = joptim.trust_ratio_clip(trust).update(updates, optax.EmptyState(), params)
        new_params = optax.apply_updates(params, updates)
        ok = jnp.isfinite(loss) & jnp.isfinite(gnorm)
        raw_tail = jnp.where(ok, raw_tail, jnp.zeros_like(raw_tail))
        params_out = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new_params, params)
        opt_out = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new_opt, opt_state)
        ema = jax.tree_util.tree_map(lambda e, p: jnp.where(ok, 0.999 * e + 0.001 * p, e),
                                     ema, params_out)
        return params_out, opt_out, ema, loss, wave, gnorm, ok, raw_tail

    return jax.jit(train_step), opt


STEPS = {"plain": dict(trust=0.0, lr_mult=1.0), "trust_clip": dict(trust=0.1, lr_mult=1.0),
         "lr_mult_half": dict(trust=0.0, lr_mult=0.5)}


def port_tensors(tree, **flags):
    """A flax tree shaped like the parameters (the parameters, a moment,
    the EMA) as tensors in the port's parameter order."""
    m = port_model(**flags)
    convert.siam_from_flax(m, tree)
    return [p.detach().clone() for p in m.parameters()]


@pytest.mark.parametrize("case", list(STEPS))
def test_three_train_steps_against_the_scripts(case, jstep):
    """Three steps, each from mptpu's state after the one before (the
    parameters, Adam's moments and count, the EMA carried across by
    siam_from_flax, so that the steps are compared and not the chaos of a
    greedy trajectory), with the fixed noise: loss rtol 1e-5, gradient
    norm rtol 1e-4, the raw tail within 1e-4 of its largest; the count
    exact; the moments as the step's gradients within 1e-3 of each leaf's
    largest (from equal moments before the step, the first moments differ
    by 0.1 times the gradients' difference, the second by 1e-3 times their
    squares'; a moment's own largest can be far below its gradient's when
    the gradient changes sign between steps); the parameters
    and the EMA within 1e-6 where the entry's first moment is above 3e-2 of
    its leaf's largest, in at least 95% of all entries, and everywhere
    within twice the learning rate: Adam divides each entry by its own
    gradient, so an entry whose gradient is near the float32 noise floor
    moves by up to the learning rate either way in either package."""
    kw = STEPS[case]
    step, opt = jstep
    tm = port_model()
    params = jax.tree_util.tree_map(jnp.asarray, convert.module_to_flax(tm))
    f_tgt, tgt, tge = inputs()
    jp, jo, je = params, opt.init(params), params
    trainer = tso.SIAMOverfitStep(tm, tso.LossSettings(WINDOW, STEP, 1e-3, 10.0), lr=LR,
                                  trust_ratio=kw["trust"], ema=0.999)
    for k in range(3):
        convert.siam_from_flax(tm, jp)
        adam = jo[0]
        trainer.opt_state = toptim.AdamState(torch.tensor(int(adam.count), dtype=torch.int32),
                                             port_tensors(adam.mu), port_tensors(adam.nu))
        mu_before, nu_before = leaves(adam.mu), leaves(adam.nu)
        trainer.ema = port_tensors(je)
        jp, jo, je, jl, jw, jgn, jok, jtail = step(
            jp, jo, je, KEY, jnp.float32(2000.0), jnp.float32(1e3), jnp.float32(kw["lr_mult"]),
            jnp.float32(kw["trust"] or 1e30), f_tgt, tgt, tge)
        loss, wave, gnorm, ok, tail = trainer.step(t(jax_noise()), torch.tensor(2000.0), 1e3,
                                                   kw["lr_mult"], t(f_tgt), t(tgt),
                                                   torch.tensor(tge))
        assert bool(ok) and bool(jok)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(gnorm), float(jgn), rtol=1e-4)
        jtail = np.asarray(jtail)
        assert np.abs(tail.numpy() - jtail).max() <= 1e-4 * np.abs(jtail).max()
        adam = jo[0]
        assert int(trainer.opt_state.count) == int(adam.count) == k + 1
        mu, nu = leaves(adam.mu), leaves(adam.nu)
        got_mu = port_leaves(tm, trainer.opt_state.mu)
        got_nu = port_leaves(tm, trainer.opt_state.nu)
        for name in mu:
            # from the same moments before the step, the moments differ by
            # (1 - b) times the step's gradients' difference (squares for nu)
            g = (mu[name] - 0.9 * mu_before[name]) / 0.1
            scale = max(float(np.abs(g).max()), 1e-30)
            assert np.abs(got_mu[name] - mu[name]).max() <= STEP_GRAD_TOL * 0.1 * scale, name
            assert np.abs(got_nu[name] - nu[name]).max() <= 2 * STEP_GRAD_TOL * 1e-3 * scale**2, \
                name
        strong = {k: np.abs(m) >= 3e-2 * np.abs(m).max() for k, m in mu.items()}
        for what, got, want in (("params", port_leaves(tm, trainer.params), leaves(jp)),
                                ("ema", port_leaves(tm, trainer.ema), leaves(je))):
            far = 0
            for name, w in want.items():
                d = np.abs(got[name] - w)
                assert d[strong[name]].max(initial=0.0) <= 1e-6, (what, name)
                assert d.max() <= 2 * LR * 1.1, (what, name)
                far += int((d > 1e-6).sum())
            assert far <= 0.05 * sum(w.size for w in want.values()), (what, far)


def test_the_gate_keeps_everything_on_a_non_finite_step(jstep):
    """A NaN waveform weight makes the loss NaN: the parameters, Adam's
    moments and count and the EMA come back bit-identical, the raw tail is
    zero, and the step read nothing on the host; mptpu's step gates alike."""
    step, opt = jstep
    tm = port_model()
    trainer = tso.SIAMOverfitStep(tm, tso.LossSettings(WINDOW, STEP, 1e-3, 10.0), lr=LR,
                                  ema=0.999)
    f_tgt, tgt, tge = inputs()
    args = (t(f_tgt), t(tgt), torch.tensor(tge))
    trainer.step(t(jax_noise()), torch.tensor(2000.0), 1e3, 1.0, *args)
    before = ([p.clone() for p in trainer.params], trainer.opt_state,
              [e.clone() for e in trainer.ema])
    loss, _, gnorm, ok, tail = trainer.step(t(jax_noise()), torch.tensor(float("nan")), 1e3, 1.0,
                                            *args)
    assert not bool(ok) and not math.isfinite(float(loss))
    assert torch.equal(tail, torch.zeros_like(tail))
    for a, b in zip(trainer.params, before[0]):
        assert torch.equal(a, b)
    for a, b in zip(trainer.ema, before[2]):
        assert torch.equal(a, b)
    st, old = trainer.opt_state, before[1]
    assert torch.equal(st.count, old.count)
    assert all(torch.equal(a, b) for a, b in zip(st.mu + st.nu, old.mu + old.nu))
    params = jax.tree_util.tree_map(jnp.asarray, convert.module_to_flax(port_model()))
    o = opt.init(params)
    jp, jo, _, _, _, _, jok, jtail = step(params, o, params, KEY, jnp.float32(np.nan),
                                          jnp.float32(1e3), jnp.float32(1.0), jnp.float32(1e30),
                                          f_tgt, tgt, tge)
    assert not bool(jok) and not np.asarray(jtail).any()
    assert int(jo[0].count) == 0
    for k, v in leaves(jp).items():
        np.testing.assert_array_equal(v, leaves(params)[k])


# ---- step 4: StormGuard -------------------------------------------------------------------------

SCENARIOS = [name for name in dir(storm_scenarios) if name.startswith("test_")]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_storm_guard_scenario(scenario, monkeypatch):
    """Every scenario of tests/test_storm_guard.py, run on the port's
    StormGuard in place of mptpu's."""
    monkeypatch.setattr(storm_scenarios, "StormGuard", TGuard)
    getattr(storm_scenarios, scenario)()


def guard_state(g):
    return (g.gnorm_hist, g.last_spike_iter, g.last_spike_gnorm, g.last_escalation_iter,
            g.snap_candidate, g.good, g.rollbacks, g.total_rollbacks)


def test_storm_guard_twin_replay():
    """A seeded random run of classify, healthy_boundary, rollbacks and
    catastrophic restores: every verdict and every field equal to
    mptpu's."""
    rng = np.random.default_rng(7)
    guards = [cls(grad_clip=1e3, loss_catastrophe=1e5) for cls in (JGuard, TGuard)]
    for g in guards:
        g.set_initial("s0", 0)
    for i in range(1, 3000):
        gnorm = float(rng.lognormal(1.5, 2.5))
        loss = float(rng.choice([100.0, 100.0, 100.0, 2e5, np.inf]))
        ok = bool(rng.random() > 0.01)
        out = [g.classify(i, loss, gnorm, ok) for g in guards]
        assert out[0] == out[1]
        if out[0] == "bad":
            assert guards[0].rollback_target() == guards[1].rollback_target()
            assert guards[0].note_rollback() == guards[1].note_rollback()
        if i % 50 == 0:
            assert guards[0].healthy_boundary(i, f"s{i}") == guards[1].healthy_boundary(i, f"s{i}")
        if i % 700 == 0:
            for g in guards:
                g.catastrophic_restore(f"c{i}", i - 10)
        assert guard_state(guards[0]) == guard_state(guards[1])


def cliff_run(cls, rewind: bool, limit: int = 4000):
    """A run that falls off one cliff 60 steps after every restore: the
    trainer's loop index (rewind=False) runs on after a rollback, as
    scripts/siam_overfit.py's does; rewind=True is the loop that
    test_storm_guard.py simulates. Returns the step it aborted at, or
    None."""
    g = cls(grad_clip=1e3, loss_catastrophe=1e5)
    g.set_initial("s0", 0)
    i, since = 1, 0
    while i < limit:
        since += 1
        if since == 60:
            assert g.classify(i, 2e5, 5.0, True) == cls.BAD
            (_, good_step) = g.rollback_target()
            if g.note_rollback():
                return i
            since = 0
            i = good_step + 1 if rewind else i + 1
            continue
        g.classify(i, 100.0, 5.0, True)
        if i % 50 == 0:
            g.healthy_boundary(i, f"s{i}")
        i += 1
    return None


@pytest.mark.parametrize("cls", [JGuard, TGuard], ids=["mptpu", "port"])
def test_storm_guard_never_aborts_with_the_trainers_loop_index(cls):
    """Divergence kept from mptpu (ROADMAP C, mptpu/train/guard.py:203):
    the abort counter resets on progress against a loop index that never
    rewinds, so a run that falls off the same cliff every 60 steps is not
    aborted in 4,000 steps, where a rewinding index aborts it."""
    assert cliff_run(cls, rewind=False) is None
    assert cliff_run(cls, rewind=True) is not None


# ---- step 8: Reservoir and random_sequence ------------------------------------------------------


def test_reservoir_is_bit_identical():
    rng = np.random.default_rng(3)
    jr, tr = js.Reservoir(16, 4, seed=2), ts.Reservoir(16, 4, seed=2)
    for k in range(5):
        vecs = rng.standard_normal((2, 3 + k, 4)).astype(np.float32)
        jr.update(vecs)
        tr.update(vecs)
        np.testing.assert_array_equal(tr.buffer, jr.buffer)
        np.testing.assert_array_equal(tr.sample(2, 3), jr.sample(2, 3))


def test_random_sequence_with_mptpus_draws():
    """make_random_sequence_fn with mptpu's normal, uniform and Bernoulli
    draws (split(key, 4)) and decoder noise (fold_in(k4, i)) fed in: times
    equal, audio within 1e-4 of its largest."""
    tm = port_model()
    jm = js.SIAMModel(**CFG)
    params = jax.tree_util.tree_map(jnp.asarray, convert.module_to_flax(tm))
    vecs = (0.1 * np.random.default_rng(4).standard_normal((1, E, 16))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    audio, _, times = jax.jit(js.make_random_sequence_fn(jm))(params, vecs, key)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    shape = (1, E, tm.n_frames)
    draws = dict(normal=t(jax.random.normal(k1, shape)),
                 uniform_draw=t(jax.random.uniform(k2, shape)),
                 bernoulli=torch.from_numpy(np.array(jax.random.bernoulli(k3, 0.5, shape))),
                 noise=t(jax_noise(E, k4)))
    got, _, got_times = ts.make_random_sequence_fn(tm)(t(vecs), **draws)
    np.testing.assert_allclose(got_times.numpy(), np.asarray(times), rtol=1e-6)
    audio = np.asarray(audio)
    assert np.abs(got.numpy() - audio).max() <= 1e-4 * np.abs(audio).max()


# ---- the eval metrics, and the checkpoint tree ---------------------------------------------------


def test_eval_metrics():
    """snr_db, lsd_db and pif_dist on a target and a noisy reconstruction
    against the script's (jitted): within 1e-4 dB, 1e-2 dB and 1e-5 (the
    LSD takes 20 log10 of magnitudes down to 1e-8, where the two FFTs'
    float32 rounding differs)."""
    _, tgt, _ = inputs()
    recon = (tgt + 0.05 * np.random.default_rng(2).standard_normal(tgt.shape)).astype(np.float32)

    def jsnr(a, b):
        return 10.0 * jnp.log10(jnp.maximum(jnp.sum(a**2), 1e-12)
                                / jnp.maximum(jnp.sum((a - b) ** 2), 1e-12))

    def jlsd(a, b):
        ta, tb = js.siam_transform(a, WINDOW, STEP), js.siam_transform(b, WINDOW, STEP)
        return jnp.sqrt(jnp.mean((20 * jnp.log10(ta + 1e-8) - 20 * jnp.log10(tb + 1e-8)) ** 2))

    for a, b in ((tgt[..., :HALF], recon[..., :HALF]), (tgt, recon), (tgt, np.zeros_like(tgt))):
        assert abs(float(tso.snr_db(t(a), t(b))) - float(jax.jit(jsnr)(a, b))) <= 1e-4
        assert abs(float(tso.lsd_db(t(a), t(b), WINDOW, STEP)) - float(jax.jit(jlsd)(a, b))) <= 1e-2
        assert abs(tso.pif_dist(t(a), t(b)) - float(jax.jit(j_pif_distance)(a, b))) <= 1e-5
    assert tso.pif_dist(t(tgt), torch.zeros(1, 1, N)) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("flags", ["sw6", "skip_filter"])
def test_siam_to_flax_inverts_siam_from_flax(flags):
    """siam_from_flax(module_to_flax(a)) gives a's parameters to another
    model exactly, and module_to_flax of that gives the tree back."""
    a, b = port_model(1, **FLAGS[flags]), port_model(2, **FLAGS[flags])
    tree = convert.module_to_flax(a)
    convert.siam_from_flax(b, tree)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    back = leaves(convert.module_to_flax(b))
    for k, v in leaves(tree).items():
        np.testing.assert_array_equal(back[k], v)
    paths = convert.flax_paths(a)
    assert len(paths) == len(back) == len(list(a.parameters()))
