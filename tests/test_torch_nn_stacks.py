"""The ``nn`` stacks of ROADMAP A4 in the port against ``mptpu`` on
JAX-CPU: ``DilatedStack``, ``MixerStack`` (deterministic, and with
flax's dropout masks carried across), ``Transformer``, ``fourier_mix``,
``MetaFormer``, ``UNet``, ``DownsamplingDiscriminator``,
``AntiCausalAnalysis`` with ``do_norm``, and ``convert``'s round trip of
each family's variables. The same numpy inputs from a seed go to both
packages, flax's parameters (and ``batch_stats``) carried by
``convert.module_from_flax``.

Tolerances as ``test_torch_layers.py`` states them: forward rtol 1e-5 /
atol 1e-6 (atol 2e-6 where a batch norm or an STFT feeds the output: its
rounding reads 1.2e-6); gradients within 1e-4 of each leaf's largest
magnitude; lengths exact.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

import mptpu.nn as jnn
from mptpu_torch import convert
from mptpu_torch import nn as tnn

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4


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


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(port, want, **tol):
    np.testing.assert_allclose(port.detach().numpy() if isinstance(port, torch.Tensor)
                               else np.asarray(port), np.asarray(want), **(tol or FWD))


def close_to_peak(port, want):
    """rtol 1e-5 and atol 1e-6 of ``want``'s largest magnitude: an FFT's
    output carries rounding relative to its terms, not to each entry."""
    want = np.asarray(want)
    close(port, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def leaf_close(port, want, where=""):
    """Gradients within GRAD of the leaf's largest magnitude."""
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(port - want).max() <= GRAD * scale, (
        f"{where}: {np.abs(port - want).max() / scale:.2e} of the largest")


def trees_close(port, want, prefix="", floor=None):
    """Each leaf by :func:`leaf_close`, but for a leaf whose gradient is 0
    in exact arithmetic (a bias before a batch norm in training): both
    sides then hold float32 noise, and are held below 1e-6 of the tree's
    largest magnitude instead."""
    if floor is None:
        floor = 1e-6 * max(np.abs(np.asarray(v)).max()
                           for v in jax.tree_util.tree_leaves(want))
    assert set(port) == set(want), f"{prefix}: {sorted(port)} against {sorted(want)}"
    for k in want:
        if isinstance(want[k], dict):
            trees_close(port[k], want[k], f"{prefix}/{k}", floor)
        elif max(np.abs(np.asarray(port[k])).max(), np.abs(np.asarray(want[k])).max()) < floor:
            continue
        else:
            leaf_close(port[k], want[k], f"{prefix}/{k}")


def port_grads_as_flax(module, loss):
    """The gradients of ``loss`` by ``module``'s parameters, laid out as
    its flax parameter tree."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for p, g in zip(shadow.parameters(), grads):
            p.copy_(g)
    return convert.module_to_flax(shadow)["params"]


def compare_module(jmod, tmod, args, rtol_fwd=None, seed=9, **apply_kw):
    """Init ``jmod`` on ``args``, carry its variables into ``tmod``, and
    compare the forward and the gradient of ``sum(out * cotangent)`` by
    the parameters (one jitted function on mptpu's side). Returns
    (mptpu's variables, the port's output)."""
    jargs = [jnp.asarray(a) for a in args]
    variables = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **apply_kw))(*jargs)
    convert.module_from_flax(tmod, variables)
    shape = jax.eval_shape(lambda v: jmod.apply(v, *jargs, **apply_kw), variables).shape
    cot = rand(*shape, seed=seed)

    @jax.jit
    def j_fwd_grad(params):
        def f(p):
            out = jmod.apply({**variables, "params": p}, *jargs, **apply_kw)
            return jnp.sum(out * jnp.asarray(cot)), out

        (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        return out, grads

    out, grads = j_fwd_grad(variables["params"])
    tout = tmod(*(t(a) for a in args))
    close(tout, out, **(rtol_fwd or {}))
    trees_close(port_grads_as_flax(tmod, torch.sum(tout * t(cot))), grads)
    return variables, tout


# ---- nn/dilated.py, nn/mixer.py, nn/transformer.py


@pytest.mark.parametrize("padding", [None, "only-past", "only-future"])
def test_dilated_stack(padding):
    x = rand(2, 6, 40)
    jm = jnn.DilatedStack(6, (1, 3, 9), padding)
    tm = tnn.DilatedStack(6, (1, 3, 9), padding, device="cpu")
    variables, out = compare_module(jm, tm, [x])
    assert out.shape == (2, 6, 40)
    _, feats = tm(t(x), return_features=True)
    _, jfeats = jm.apply(variables, jnp.asarray(x), return_features=True)
    for f, jf in zip(feats, jfeats):
        close(f, jf)


def test_mixer_stack_deterministic():
    kw = dict(in_channels=5, channels=8, sequence_length=12, layers=2, attn_blocks=3)
    compare_module(jnn.MixerStack(**kw), tnn.MixerStack(**kw, device="cpu"), [rand(2, 12, 5)])
    kw["channels_last"] = False
    compare_module(jnn.MixerStack(**kw), tnn.MixerStack(**kw, device="cpu"), [rand(2, 5, 12)])


def test_mixer_stack_with_dropout_masks_carried_across():
    """flax's Dropout calls intercepted to take the same numpy masks, in
    call order, as the port's ``masks`` iterator."""
    kw = dict(in_channels=5, channels=8, sequence_length=12, layers=2, attn_blocks=2)
    x = rand(2, 12, 5)
    rng = np.random.default_rng(3)
    masks = [rng.random((2, 12, 8)) < 0.9 for _ in range(4)]
    jm, tm = jnn.MixerStack(**kw), tnn.MixerStack(**kw, device="cpu")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    convert.module_from_flax(tm, variables)

    def j_apply(params):
        queue = iter(masks)

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                (inputs,) = args
                return jnp.where(next(queue), inputs / 0.9, 0.0)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            return jm.apply({"params": params}, jnp.asarray(x), deterministic=False)

    want = jax.jit(j_apply)(variables["params"])
    got = tm(t(x), deterministic=False, masks=iter(torch.from_numpy(m) for m in masks))
    close(got, want)
    assert not np.allclose(np.asarray(want), np.asarray(jm.apply(variables, jnp.asarray(x))))
    cot = rand(2, 12, 8, seed=4)
    tm2 = convert.module_from_flax(tnn.MixerStack(**kw, device="cpu"), variables)
    out2 = tm2(t(x), deterministic=False, masks=iter(torch.from_numpy(m) for m in masks))
    trees_close(port_grads_as_flax(tm2, torch.sum(out2 * t(cot))),
                jax.jit(jax.grad(lambda p: jnp.sum(j_apply(p) * cot)))(variables["params"]))
    drawn = tm(t(x), deterministic=False, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all()


def test_transformer_and_fourier_mix():
    x = rand(2, 8, 16)
    compare_module(jnn.Transformer(16, 3), tnn.Transformer(16, 3, device="cpu"), [x])
    close(tnn.fourier_mix(t(x)), jnn.fourier_mix(jnp.asarray(x)))
    close(tnn.FourierMixer()(t(x)), jnn.FourierMixer().apply({}, jnp.asarray(x)))
    jm = jnn.Transformer(16, 2, return_features=True)
    tm = tnn.Transformer(16, 2, return_features=True, device="cpu")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    convert.module_from_flax(tm, variables)
    (out, feats), (jout, jfeats) = tm(t(x)), jm.apply(variables, jnp.asarray(x))
    assert len(feats) == len(jfeats) == 2
    for f, jf in zip(feats, jfeats):
        close(f, jf)


def test_metaformer_tanh_gelu_and_layer_norm_eps():
    x = rand(2, 9, 8, scale=2.0)
    _, out = compare_module(jnn.MetaFormer(8, 2), tnn.MetaFormer(8, 2, device="cpu"), [x])
    # PyTorch's exact GELU or its LayerNorm eps of 1e-5 would read far off
    block = tnn.MetaFormerBlock(8, device="cpu")
    h = torch.linspace(-3, 3, 7)
    assert not torch.allclose(torch.nn.functional.gelu(h), torch.nn.functional.gelu(
        h, approximate="tanh"), atol=1e-4)
    v = torch.linspace(0.0, 7e-3, 8)[None]   # a variance of 5.25e-6, where eps tells
    ln = torch.nn.functional.layer_norm
    torch.testing.assert_close(block.LayerNorm_0(v), ln(v, (8,), eps=1e-6))
    assert not torch.allclose(block.LayerNorm_0(v), ln(v, (8,), eps=1e-5), atol=1e-2)


# ---- nn/unet.py, AntiCausalAnalysis's do_norm


@pytest.mark.parametrize("is_disc", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_unet_lengths_and_values(is_disc, train):
    """From 128 samples the down path gives 64 ... 4 and the up path flax's
    2 n - 2 lengths, 6 ... 66, none of which meets a down length: no skip
    connection is added, in mptpu as here."""
    kw = dict(channels=6, is_disc=is_disc, out_channels=5)
    x = rand(2, 6, 128)
    jm, tm = jnn.UNet(**kw), tnn.UNet(**kw, device="cpu")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(
        lambda v: v + 0.1, variables["batch_stats"])}
    convert.module_from_flax(tm, variables)
    want, updated = jax.jit(functools.partial(jm.apply, train=train, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got = tm(t(x), train=train)
    assert got.shape == want.shape == ((2, 1, 1) if is_disc else (2, 5, 66))
    close(got, want, rtol=1e-5, atol=2e-6)
    trees_close(convert.module_to_flax(tm)["batch_stats"], updated["batch_stats"])
    cot = rand(*want.shape, seed=2)
    tm2 = convert.module_from_flax(tnn.UNet(**kw, device="cpu"), variables)
    trees_close(port_grads_as_flax(tm2, torch.sum(tm2(t(x), train=train) * t(cot))),
                jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(
                    {**variables, "params": p}, jnp.asarray(x), train=train,
                    mutable=["batch_stats"])[0] * cot)))(variables["params"]))


def test_unet_skip_connection_where_lengths_meet():
    """At 3 levels from 16 samples: down 8, 4, 2; up 2, 2, 2, each added to
    the down layer of length 2."""
    kw = dict(channels=4, out_channels=3, levels=3, norm=False)
    _, out = compare_module(jnn.UNet(**kw), tnn.UNet(**kw, device="cpu"), [rand(2, 4, 16)])
    assert out.shape == (2, 3, 2)


@pytest.mark.parametrize("complex_valued", [False, True])
def test_downsampling_discriminator(complex_valued):
    kw = dict(window_size=64, step_size=32, n_samples=1024, channels=8,
              complex_valued=complex_valued)
    _, out = compare_module(jnn.DownsamplingDiscriminator(**kw),
                            tnn.DownsamplingDiscriminator(**kw, device="cpu"),
                            [rand(2, 1, 1024)], rtol_fwd=dict(rtol=1e-5, atol=2e-6))
    assert out.shape == (2, 1, 1)


@pytest.mark.parametrize("train", [False, True])
def test_anticausal_analysis_do_norm(train):
    kw = dict(in_channels=5, channels=6, kernel_size=2, dilations=(1, 2, 4), do_norm=True)
    x = rand(2, 5, 32)
    jm, tm = jnn.AntiCausalAnalysis(**kw), tnn.AntiCausalAnalysis(**kw, device="cpu")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(
        lambda v: v * 0.5 + 0.2, variables["batch_stats"])}
    convert.module_from_flax(tm, variables)
    want, updated = jax.jit(functools.partial(jm.apply, train=train, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got = tm(t(x), train=train)
    close(got, want, rtol=1e-5, atol=2e-6)
    trees_close(convert.module_to_flax(tm)["batch_stats"], updated["batch_stats"])
    cot = rand(2, 6, 32, seed=3)
    tm2 = convert.module_from_flax(tnn.AntiCausalAnalysis(**kw, device="cpu"), variables)
    trees_close(port_grads_as_flax(tm2, torch.sum(tm2(t(x), train=train) * t(cot))),
                jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(
                    {**variables, "params": p}, jnp.asarray(x), train=train,
                    mutable=["batch_stats"])[0] * cot)))(variables["params"]))


# ---- convert.py round trips


FAMILIES = {
    "dilated": lambda: (tnn.DilatedStack(4, (1, 2), device="cpu"),
                        jnn.DilatedStack(4, (1, 2)), [rand(1, 4, 8)]),
    "mixer": lambda: (tnn.MixerStack(3, 4, 6, 1, 2, device="cpu"),
                      jnn.MixerStack(3, 4, 6, 1, 2), [rand(1, 6, 3)]),
    "transformer": lambda: (tnn.Transformer(4, 2, device="cpu"), jnn.Transformer(4, 2),
                            [rand(1, 3, 4)]),
    "metaformer": lambda: (tnn.MetaFormer(4, 1, device="cpu"), jnn.MetaFormer(4, 1),
                           [rand(1, 3, 4)]),
    "unet": lambda: (tnn.UNet(4, out_channels=3, device="cpu"), jnn.UNet(4, out_channels=3),
                     [rand(1, 4, 128)]),
    "upsample": lambda: (tnn.ConvUpsample(3, 4, 4, 16, "learned", batch_norm=True,
                                          device="cpu"),
                         jnn.ConvUpsample(3, 4, 4, 16, "learned", batch_norm=True),
                         [rand(1, 3)]),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_convert_round_trip(family):
    tm, jm, args = FAMILIES[family]()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in args))
    back = convert.module_to_flax(convert.module_from_flax(tm, variables))
    assert set(back) == set(variables)
    for col in variables:
        flat = jax.tree_util.tree_leaves_with_path(variables[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(got) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(got[path], np.asarray(leaf))
    with pytest.raises(ValueError):
        convert.module_from_flax(tm, {"params": {**variables["params"], "extra": np.zeros(1)}})
