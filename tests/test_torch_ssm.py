"""The playable state-space model (BASELINE #5) in the port against
``mptpu`` on JAX-CPU, at small sizes (8 to 128 frames, widths 8 to 32, 512
to 4,096 samples): overlap-add, the scan in its 2-D and per-item 3-D
forms, ``state_space_model``, ``SSM``, the hypernetwork and the SSM event
generator, ``ComplexSSM`` in both domains, ``CompressionModel`` and
``param_count``, ``InstrumentModel`` and ``OverfitControlPlane`` with
``random`` and ``rolled_control_plane`` fed ``mptpu``'s draws, and
``scripts/ssm_article.py``'s ``transform``, ``l0_norm``,
``generate_param_dict``, jitted Adam step and NaN guard. ``mptpu``'s flax
parameters cross by ``convert.ssm_from_flax``.

Tolerances (each test names its own where it differs): values and
gradients rtol 1e-4 and an atol of 1e-5 times the reference's largest
magnitude, the rounding of float32 products and FFTs taken in other
orders. JAX's gradient of a real loss with respect to a complex leaf is
the conjugate of torch's ``.grad``: complex gradients are compared as
``conj(mptpu's)``.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.data import datastore as jds
from mptpu.data import get_one_audio_segment as j_segment
from mptpu.gen import ssm as jssm
from mptpu.gen import ssm_complex as jcx
from mptpu.models import ssm_overfit as jov
from mptpu.ops.overlap_add import overlap_add as j_overlap_add
from mptpu_torch import convert
from mptpu_torch.gen import ssm as tssm
from mptpu_torch.gen import ssm_complex as tcx
from mptpu_torch.models import ssm_overfit as tov
from mptpu_torch.ops.overlap_add import overlap_add as t_overlap_add

ROOT = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(0)


def load_script():
    """scripts/ssm_article.py as a module (it sets JAX's platform from
    JAX_PLATFORMS, the CPU here, when imported)."""
    spec = importlib.util.spec_from_file_location("ssm_article", ROOT / "scripts" / "ssm_article.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SCRIPT = load_script()


def normal(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(shape), np.float32)


def close(got, want, rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def t(x):
    return torch.from_numpy(np.array(x))


def flax_grads(tree, prefix=""):
    """{"a/b/c": gradient} of a flax gradient tree, complex leaves conjugated
    into torch's convention."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flax_grads(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.conj(np.asarray(v)) if np.iscomplexobj(v) else np.asarray(v)
    return out


def torch_grads(module, loss):
    """{"a/b/c": gradient} of ``module``'s parameters under flax's names: an
    ``nn.Linear`` weight as a kernel and ``nn.RNN``'s weights as ``w_ih``,
    ``w_hh``, transposed back."""
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params)
    out = {}
    for name, g in zip(names, grads):
        parts, g = name.split("."), g.numpy()
        if parts[-2:] in (["rnn", "weight_ih_l0"], ["rnn", "weight_hh_l0"]):
            parts, g = parts[:-2] + ["w_" + parts[-1].split("_")[1]], g.T
        elif parts[-1] == "weight":
            parts[-1], g = "kernel", g.T
        out["/".join(parts)] = g
    return out


def jax_vjp(fn, args, seed):
    """One jitted call of ``fn(*args)`` and the gradients of ``sum(out * w)``
    into every argument, ``w`` normals of the output's shape from ``seed``;
    returns (out, gradients, w). (Eager JAX is some four times slower.)"""
    w = normal(jax.eval_shape(fn, *args).shape, seed)

    def run(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(w))

    out, grads = jax.jit(run)(*args)
    return out, grads, w


def init(module, *args):
    """``module.init(KEY, *args)`` jitted, as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(module.init)(KEY, *args))


def grads_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], **tol)


# overlap-add ---------------------------------------------------------------------------------

@pytest.mark.parametrize("apply_window,flip,trim", [
    (True, False, None), (False, False, None), (True, True, None), (False, True, 40),
    (True, False, 100)])
def test_overlap_add(apply_window, flip, trim):
    x = normal((2, 3, 7, 16), 1)
    want, (jg,), w = jax_vjp(lambda v: j_overlap_add(v, apply_window, flip, trim), [x], 2)
    xt = t(x).requires_grad_()
    got = t_overlap_add(xt, apply_window=apply_window, flip=flip, trim=trim)
    close(got.detach().numpy(), want)
    (g,) = torch.autograd.grad((got * t(w)).sum(), xt)
    close(g.numpy(), jg)


# the real SSM family -------------------------------------------------------------------------

def matrices(batched, seed, inp=16, state=8, batch=2):
    lead = (batch,) if batched else ()
    shapes = dict(state_matrix=(state, state), input_matrix=(inp, state),
                  output_matrix=(state, inp), direct_matrix=(inp, inp))
    return {k: normal(lead + s, seed + i, 0.2) for i, (k, s) in enumerate(shapes.items())}


@pytest.mark.parametrize("batched", [False, True])
def test_ssm_scan(batched):
    """The recurrence, forward and the gradient into every input, with 2-D
    matrices and with one matrix per item."""
    m = matrices(batched, 3)
    proj = normal((2, 12, 16), 9)
    args = [proj, m["state_matrix"], m["input_matrix"], m["output_matrix"], m["direct_matrix"]]
    want, jgs, w = jax_vjp(lambda *a: jssm.ssm_scan(*a, 8), args, 10)
    ts_ = [t(a).requires_grad_() for a in args]
    got = tssm.ssm_scan(*ts_, 8)
    close(got.detach().numpy(), want)
    for g, jg in zip(torch.autograd.grad((got * t(w)).sum(), ts_), jgs):
        close(g.numpy(), jg)


@pytest.mark.parametrize("batched,windowed", [(False, True), (True, True), (False, False)])
def test_state_space_model(batched, windowed):
    m = matrices(batched, 20)
    proj_m = normal(((2,) if batched else ()) + (6, 16), 25, 0.3)
    control = normal((2, 6, 10), 26)
    n = 10 * 8 - 3
    args = [control, proj_m, m["state_matrix"], m["input_matrix"], m["output_matrix"],
            m["direct_matrix"]]
    fn_j = lambda *a: jssm.state_space_model(*a, 8, 16, n, windowed=windowed)
    want, jgs, w = jax_vjp(fn_j, args, 27)
    ts_ = [t(a).requires_grad_() for a in args]
    got = tssm.state_space_model(*ts_, 8, 16, n, windowed=windowed)
    assert tuple(got.shape) == (2, 1, n)
    close(got.detach().numpy(), want)
    for g, jg in zip(torch.autograd.grad((got * t(w)).sum(), ts_), jgs):
        close(g.numpy(), jg)


@pytest.mark.parametrize("windowed", [True, False])
def test_ssm_module(windowed):
    jm = jssm.SSM(control_plane_dim=8, input_dim=32, state_matrix_dim=16, windowed=windowed)
    control = normal((2, 8, 9), 30)
    variables = init(jm, control)
    tm = convert.ssm_from_flax(tssm.SSM(8, 32, 16, windowed=windowed, device="cpu"), variables)
    want, (jg,), w = jax_vjp(lambda v: jm.apply(v, jnp.asarray(control)), [variables], 31)
    got = tm(t(control))
    assert tuple(got.shape) == (2, 1, 9 * 16)
    close(got.detach().numpy(), want)
    grads_close(torch_grads(tm, (got * t(w)).sum()), flax_grads(jg["params"]))


def test_hypernetwork_layer():
    jm = jssm.HyperNetworkLayer(16, 4, 8, 12)
    x = normal((3, 16), 40)
    variables = init(jm, x)
    tm = convert.ssm_from_flax(
        tssm.HyperNetworkLayer(16, 4, 8, 12, torch.Generator(), device="cpu"), variables)
    want, (jg,), w = jax_vjp(lambda v: jm.apply(v, jnp.asarray(x)), [variables], 41)
    assert want.shape == (3, 8, 12)
    got = tm(t(x))
    close(got.detach().numpy(), want)
    grads_close(torch_grads(tm, (got * t(w)).sum()), flax_grads(jg["params"]))


GEN = dict(context_dim=16, control_plane_dim=8, input_dim=16, state_dim=8, hypernetwork_dim=12,
           hypernetwork_latent=4, n_samples=512, samplerate=22050, n_frames=64)


def test_state_space_model_event_generator():
    """Three events of per-event matrices, scheduled by the Dirac scheduler;
    forward and every gradient (the hypernetworks' and the inputs')."""
    jm = jssm.StateSpaceModelEventGenerator(**GEN)
    spec = jm.shape_spec
    rng = np.random.default_rng(50)
    inputs = {k: (0.3 * rng.standard_normal((1, 3) + s)).astype(np.float32)
              for k, s in spec.items()}
    variables = init(jm, inputs)
    tm = convert.ssm_from_flax(tssm.StateSpaceModelEventGenerator(**GEN, device="cpu"),
                               variables)
    assert tm.shape_spec == spec
    want, (jg_v, jg_in), w = jax_vjp(jm.apply, [variables, inputs], 51)
    assert want.shape == (1, 3, GEN["n_samples"])
    ti = {k: t(v).requires_grad_() for k, v in inputs.items()}
    got = tm(ti)
    close(got.detach().numpy(), want)
    grads_close(torch_grads(tm, (got * t(w)).sum()), flax_grads(jg_v["params"]))
    got_in = torch.autograd.grad((tm(ti) * t(w)).sum(), list(ti.values()))
    for k, g in zip(ti, got_in):
        close(g.numpy(), jg_in[k])


# the complex-spectral SSM --------------------------------------------------------------------

@pytest.mark.parametrize("complex_domain", [True, False])
def test_complex_ssm(complex_domain):
    """Both domains, forward and gradients, on a control signal given in."""
    jm = jcx.ComplexSSM(8, 32, 16, complex_domain=complex_domain)
    control = normal((2, 8, 12), 60)
    variables = init(jm, control)
    tm = convert.ssm_from_flax(tcx.ComplexSSM(8, 32, 16, complex_domain=complex_domain,
                                              device="cpu"), variables)
    assert all(p.is_complex() == complex_domain for p in tm.parameters())
    want, (jg_v, jg_c), w = jax_vjp(jm.apply, [variables, control], 61)
    close(tm(t(control)).detach().numpy(), want)
    grads_close(torch_grads(tm, (tm(t(control)) * t(w)).sum()), flax_grads(jg_v["params"]))
    ct = t(control).requires_grad_()
    (g,) = torch.autograd.grad((tm(ct) * t(w)).sum(), ct)
    close(g.numpy(), jg_c)


@pytest.mark.parametrize("complex_domain", [True, False])
def test_compression_model(complex_domain):
    """``CompressionModel``'s own control plane, the gradient of
    ``sum(|audio|)`` (tests/test_models_extra.py's loss), and
    ``param_count``."""
    kw = dict(control_plane_dim=8, input_dim=64, state_matrix_dim=16, n_samples=2048,
              complex_domain=complex_domain)
    jm = jcx.CompressionModel(**kw)
    variables = init(jm)
    tm = convert.ssm_from_flax(tcx.CompressionModel(**kw, device="cpu"), variables)
    def loss(v):
        audio = jm.apply(v)
        return jnp.sum(jnp.abs(audio)), audio

    (_, audio), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    got = tm()
    assert tuple(got.shape) == (1, 1, 2048)
    close(got.detach().numpy(), audio)
    grads_close(torch_grads(tm, tm().abs().sum()), flax_grads(jg["params"]))
    assert tcx.param_count(tm) == jcx.param_count(variables)
    assert tcx.param_count([p.detach().numpy() for p in tm.parameters()]) == tcx.param_count(tm)


def test_compression_model_param_count_at_full_width():
    """The codec's defaults (2^17 samples, window 1024, control 32, state
    64, complex): 8,192 control values and 306,837 complex matrix entries."""
    assert tcx.param_count(tcx.CompressionModel(device="cpu")) == 621_866


# the overfit instrument ----------------------------------------------------------------------

OV = dict(control_plane_dim=8, input_dim=16, state_matrix_dim=16, n_samples=512, window_size=16,
          n_active_sites=16)


@pytest.fixture(scope="module")
def overfit_pair():
    jm = jov.OverfitControlPlane(**OV)
    variables = init(jm)
    tm = convert.ssm_from_flax(tov.OverfitControlPlane(**OV, device="cpu"), variables)
    return jm, variables, tm


def test_overfit_control_plane(overfit_pair):
    """The sparse control plane through the instrument: audio, boundary
    differences and every gradient (the RNN's as w_ih, w_hh)."""
    jm, variables, tm = overfit_pair
    w = normal((1, 1, 512), 70)

    def loss_j(v):
        a, d = jm.apply(v)
        return jnp.sum(a * w) + jnp.sum(d ** 2), (a, d)

    (_, (audio, diff)), jg = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(variables)
    got_audio, got_diff = tm()
    assert tuple(got_audio.shape) == (1, 1, 512) and tuple(got_diff.shape) == (1, 31)
    close(got_audio.detach().numpy(), audio)
    close(got_diff.detach().numpy(), diff)
    grads_close(torch_grads(tm, (got_audio * t(w)).sum() + (got_diff ** 2).sum()),
                flax_grads(jg["params"]))


def test_instrument_model_alone():
    jm = jov.InstrumentModel(8, 16, 16, 16)
    control = np.abs(normal((2, 8, 20), 71))
    variables = init(jm, control)
    tm = convert.ssm_from_flax(tov.InstrumentModel(8, 16, 16, 16, torch.Generator(),
                                                   device="cpu"), variables)
    for got, want in zip(tm(t(control)), jax.jit(jm.apply)(variables, control)):
        close(got.detach().numpy(), want)


def test_random_and_rolled_with_mptpus_draws(overfit_pair):
    """``random`` fed ``mptpu``'s Bernoulli draw and ``rolled_control_plane``
    its permutation give ``mptpu``'s audio; with generators instead they
    give max-normed audio of the right shape."""
    jm, variables, tm = overfit_pair
    k7, k8 = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    draw = np.asarray(jax.random.bernoulli(k7, 0.05, (1, 8, 32)), np.float32)
    assert draw.sum() > 0
    random = jax.jit(lambda v, k: jm.apply(v, k, 0.05, method=jov.OverfitControlPlane.random))
    close(tm.random(0.05, draw=t(draw)).detach().numpy(), random(variables, k7))
    indices = np.asarray(jax.random.permutation(k8, 8))
    want = jax.jit(lambda v, k: jm.apply(v, k, v["params"]["control"],
                                         method=jov.OverfitControlPlane.rolled_control_plane))(
        variables, k8)
    close(tm.rolled_control_plane(indices=t(indices)).detach().numpy(), want)
    for audio in (tm.random(0.05, torch.Generator().manual_seed(7)),
                  tm.rolled_control_plane(generator=torch.Generator().manual_seed(8))):
        assert tuple(audio.shape) == (1, 1, 512)
        # max_norm divides by the largest plus 1e-8, and this audio peaks near 1e-4
        assert 0.99 < float(audio.detach().abs().max()) <= 1.0


def test_transform_and_l0_norm():
    x = normal((1, 1, 2048), 80)
    close(tov.transform(t(x)).numpy(), jax.jit(SCRIPT.transform)(x))
    x[0, 0, ::3] = 1e-7
    assert int(tov.l0_norm(t(x))) == int(SCRIPT.l0_norm(jnp.asarray(x)))


def test_generate_param_dict_equals_the_scripts(overfit_pair):
    """The same keys, in the same order, shapes and base64 bytes as
    ``scripts/ssm_article.py:generate_param_dict`` on the same parameters;
    ``read_param_dict`` gives back the tree."""
    _, variables, tm = overfit_pair
    want = SCRIPT.generate_param_dict(variables)
    got = tov.generate_param_dict(tm)
    assert list(got) == list(want)
    assert json.dumps(got) == json.dumps(want)
    back = tov.read_param_dict(got)
    fresh = convert.ssm_from_flax(tov.OverfitControlPlane(
        **OV, init_generator=torch.Generator().manual_seed(1), device="cpu"), back)
    for (k, a), b in zip(tm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_ssm_from_flax_refuses_a_tree_that_does_not_match(overfit_pair):
    _, variables, _ = overfit_pair
    params = variables["params"]
    fresh = lambda: tov.OverfitControlPlane(**OV, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.ssm_from_flax(fresh(), dict(params, extra=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="weight_hh_l0"):
        convert.ssm_from_flax(fresh(), dict(params, ssm=dict(params["ssm"],
                                                             w_hh=np.zeros((16, 8)))))
    with pytest.raises(ValueError):
        convert.ssm_from_flax(fresh(), {"control": params["control"]})
    complex_tree = init(jcx.ComplexSSM(8, 32, 16), np.zeros((1, 8, 4), np.float32))
    real_model = tcx.ComplexSSM(8, 32, 16, complex_domain=False, device="cpu")
    with pytest.raises(ValueError):
        convert.ssm_from_flax(real_model, complex_tree)


# the script: Adam, the guard, the article ----------------------------------------------------

SMALL = dict(n_samples=2048, window_size=16, control_plane_dim=8, state_dim=16,
             n_active_sites=32)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """MPTPU_CACHE at a temporary directory for both packages, no AUDIO_PATH,
    so both read the same demo corpus written there."""
    path = tmp_path_factory.mktemp("cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPTPU_CACHE", str(path))
        mp.delenv("AUDIO_PATH", raising=False)
        mp.setattr(jds, "_collection", None)
        yield path


def script_steps(tree, target, n_steps, lr=1e-2, boundary_weight=1.0):
    """``scripts/ssm_article.py:train_model_for_segment``'s jitted step from
    ``tree``: (the parameters after each step, each step's loss)."""
    model = jov.OverfitControlPlane(control_plane_dim=SMALL["control_plane_dim"],
                                    input_dim=SMALL["window_size"],
                                    state_matrix_dim=SMALL["state_dim"],
                                    n_samples=SMALL["n_samples"],
                                    window_size=SMALL["window_size"],
                                    n_active_sites=SMALL["n_active_sites"])
    t_spec = SCRIPT.transform(target)

    def loss_fn(params):
        audio, boundary_diff = model.apply(params)
        recon_loss = jnp.abs(SCRIPT.transform(audio) - t_spec).sum()
        return recon_loss + jnp.abs(boundary_diff).sum() * boundary_weight

    opt = optax.adam(lr)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, new_opt = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        ok = jnp.isfinite(loss)
        params = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new_params, params)
        return params, new_opt, loss

    trail, losses = [], []
    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state)
        trail.append(jax.tree_util.tree_map(np.asarray, params))
        losses.append(float(loss))
    return trail, losses


def test_three_adam_steps_against_the_scripts(cache_dir):
    """``train_model_for_segment`` on the CPU against the script's jitted
    optax step from the same initial parameters and the same target
    (``get_one_audio_segment`` with seed 5 in both packages, bit for bit):
    the losses within rtol 1e-4 and the parameters after three steps within
    1e-2 x lr (1e-4) of each other. Adam moves every parameter by about
    ``lr`` a step whatever the size of its gradient, so a float32
    difference of a gradient, relative to that gradient, becomes the same
    difference relative to ``lr``: it is largest in ``w_hh``, whose
    gradients are a hundredth of ``proj``'s (2.5e-3 x lr measured)."""
    gen = lambda: torch.Generator().manual_seed(3)
    fit = tov.train_model_for_segment(**SMALL, n_iterations=3, seed=5, device="cpu",
                                      init_generator=gen())
    target = j_segment(SMALL["n_samples"], seed=5)
    assert np.array_equal(fit.target.numpy(), np.asarray(target))
    start = tov.OverfitControlPlane(SMALL["control_plane_dim"], SMALL["window_size"],
                                    SMALL["state_dim"], SMALL["n_samples"],
                                    SMALL["window_size"], SMALL["n_active_sites"],
                                    init_generator=gen(), device="cpu")
    trail, losses = script_steps(tov.param_tree(start), target, 3)
    np.testing.assert_allclose(fit.losses, losses, rtol=1e-4)
    assert fit.losses[-1] < fit.losses[0] and fit.skipped == 0
    got = flax_grads(tov.param_tree(fit.model)["params"])
    want = flax_grads(trail[-1]["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-2 * 1e-2, err_msg=k)


def test_the_guard_keeps_the_parameters_and_advances_adam():
    """A non-finite loss: the parameters keep their values while Adam's
    moments take the NaN gradient and its count moves on, as optax's state
    does under the script's guard (``jnp.where`` on the parameters only)."""
    p = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = torch.optim.Adam([p], lr=0.1)
    step = tov.make_script_step(lambda: (p * torch.tensor([1.0, float("nan")])).sum(), opt)
    loss = step()
    assert not torch.isfinite(loss)
    assert torch.equal(p.detach(), torch.tensor([1.0, 2.0]))
    state = opt.state[p]
    assert float(state["step"]) == 1 and torch.isnan(state["exp_avg"]).any()

    jp = jnp.asarray([1.0, 2.0])
    jopt = optax.adam(0.1)
    jstate = jopt.init(jp)
    g = jax.grad(lambda q: jnp.sum(q * jnp.asarray([1.0, jnp.nan])))(jp)
    _, jstate = jopt.update(g, jstate, jp)
    assert int(jstate[0].count) == 1 and np.isnan(np.asarray(jstate[0].mu)).any()
    good = tov.make_script_step(lambda: (p * p).sum(), opt)
    good()
    assert torch.isnan(p.detach()).any(), "after a NaN, Adam's moments carry it on, as optax's"


def test_adam_on_a_complex_leaf():
    """One Adam step of lr 0.1 on |z|^2 at 3+4j: torch's Adam steps each part
    of a complex parameter down its own slope, to 2.9+3.9j; JAX's gradient
    is the conjugate of torch's (6-8j against 6+8j), and ``optax.adam``,
    one second moment for both parts, fed it moves z by -0.06+0.08j, up the
    slope in the imaginary part. ``mptpu`` trains no complex model; the port
    trains one with torch's Adam."""
    z = torch.nn.Parameter(torch.tensor(3 + 4j, dtype=torch.complex64))
    opt = torch.optim.Adam([z], lr=0.1)
    (z.abs() ** 2).backward()
    assert complex(z.grad) == pytest.approx(6 + 8j)
    opt.step()
    assert complex(z.detach()) == pytest.approx(2.9 + 3.9j, abs=1e-6)

    jz = jnp.asarray(3 + 4j, jnp.complex64)
    g = jax.grad(lambda v: jnp.abs(v) ** 2)(jz)
    assert complex(g) == pytest.approx(6 - 8j)
    jopt = optax.adam(0.1)
    update, _ = jopt.update(g, jopt.init(jz), jz)
    assert complex(update) == pytest.approx(-0.06 + 0.08j, abs=1e-6)


def test_train_model_for_segment_writes_the_article(cache_dir, tmp_path):
    path = tmp_path / "ssm.html"
    fit = tov.train_model_for_segment(**SMALL, n_iterations=2, seed=1, device="cpu",
                                      article_path=str(path))
    html = path.read_text()
    assert html.count("<audio controls") == 4 and "<svg" in html
    weights = json.loads((tmp_path / "ssm_weights.json").read_text())
    assert weights == tov.generate_param_dict(fit.model)


def test_entry_points_raise_without_cuda(cache_dir):
    """No quiet fallback: asked for the card where there is none, every
    entry point of the slice raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is available, nothing to refuse")
    from mptpu_torch.data import get_one_audio_segment

    calls = [lambda: tov.OverfitControlPlane(**OV, device="cuda"),
             lambda: tov.train_model_for_segment(**SMALL, n_iterations=1, device="cuda"),
             lambda: tcx.CompressionModel(device="cuda"),
             lambda: tssm.SSM(8, 16, 8, device="cuda"),
             lambda: tssm.StateSpaceModelEventGenerator(**GEN, device="cuda"),
             lambda: get_one_audio_segment(512, seed=0, device="cuda"),
             lambda: get_one_audio_segment(512, seed=0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_ssm_phase_rehearses_on_the_cpu(cache_dir):
    """chip_smoke.py's phase 8 at a small size on the CPU, where the 'card'
    is the CPU too: every check holds, no kernel is launched."""
    import chip_smoke

    chip_smoke.ssm_phase(torch.device("cpu"), chip_smoke.SSM_SMALL, lambda: None)
