"""mptpu_torch.sparse's top-k family, the two sparsity modules, quantized
selection and the wave table against mptpu on the same numpy inputs (JAX
on the CPU, the port on CPU tensors), forward and gradient.

``lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order: inputs are seeded continuous normals,
which have no ties. Tolerance: values and gradients rtol 1e-4 / atol 1e-5
(gradients: atol 1e-5 times the largest magnitude of mptpu's gradient);
top-k indices identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu import sparse as jsp
from mptpu.gen.transfer import make_waves as j_make_waves
from mptpu.sparse import quantize as jq
from mptpu.utils.music import musical_scale_hz as j_scale
from mptpu_torch import convert
from mptpu_torch import sparse as tsp
from mptpu_torch.gen import make_waves
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.utils import midi_to_hz, musical_scale_hz

TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def outputs_and_grad(jfn, tfn, x, seed):
    """Both frameworks' outputs (a tuple) and the gradient of the sum of
    every float output times a seeded weight, into ``x``."""
    jouts = jfn(jnp.asarray(x))
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    weights = [normal(o.shape, seed + i) for i, o in enumerate(jouts)]
    floats = [i for i, o in enumerate(jouts) if jnp.issubdtype(o.dtype, jnp.floating)]

    def jloss(v):
        outs = jfn(v)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(outs[i] * weights[i]) for i in floats)

    j_g = jax.grad(jloss)(jnp.asarray(x))
    xt = t(x).requires_grad_()
    touts = tfn(xt)
    touts = touts if isinstance(touts, tuple) else (touts,)
    (g,) = torch.autograd.grad(sum((touts[i] * t(weights[i])).sum() for i in floats), xt)
    return jouts, [o.detach() for o in touts], j_g, g.numpy()


def assert_same(jfn, tfn, x, seed=0):
    jouts, touts, j_g, g = outputs_and_grad(jfn, tfn, x, seed)
    for jo, to in zip(jouts, touts):
        if jnp.issubdtype(jo.dtype, jnp.floating):
            close(to.numpy(), jo)
        else:
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    grad_close(g, j_g)
    return touts


SPARSIFY = {
    "plain": dict(),
    "soft": dict(soft=True),
    "sharpen": dict(sharpen=True),
    "soft_sharpen": dict(soft=True, sharpen=True),
    "indices": dict(return_indices=True),
}


@pytest.mark.parametrize("name", sorted(SPARSIFY))
def test_sparsify_matches_mptpu(name):
    kw = SPARSIFY[name]
    x = normal((2, 12, 40), 1)
    outs = assert_same(lambda v: jsp.sparsify(v, 16, **kw), lambda v: tsp.sparsify(v, 16, **kw), x)
    assert [int(torch.count_nonzero(o)) for o in outs[0]] == [16, 16]


def test_sparsify_salience_matches_mptpu():
    x = normal((2, 8, 30), 2)
    sal = np.abs(normal((2, 8, 30), 3))
    assert_same(lambda v: jsp.sparsify(v, 10, salience=jnp.asarray(sal), soft=True),
                lambda v: tsp.sparsify(v, 10, salience=t(sal), soft=True), x)


def test_sparsify2_matches_mptpu():
    x = normal((3, 6, 20), 4)
    sparse, packed, one_hot = assert_same(lambda v: jsp.sparsify2(v, 5),
                                          lambda v: tsp.sparsify2(v, 5), x)
    assert sparse.shape == (3, 6, 20) and packed.shape == (3, 5, 20) and one_hot.shape == (3, 5, 6)


@pytest.mark.parametrize("normalize,dense", [(True, False), (False, False), (True, True)])
def test_sparsify_vectors_matches_mptpu(normalize, dense):
    x = normal((2, 6, 24), 5)
    attn = normal((2, 24), 6)

    def j(v):
        return jsp.sparsify_vectors(v, jnp.asarray(attn), 4, normalize=normalize, dense=dense)

    def tr(v):
        return tsp.sparsify_vectors(v, t(attn), 4, normalize=normalize, dense=dense)

    assert_same(j, tr, x)
    # and the gradient into the attention, through the top-k values
    assert_same(lambda a: jsp.sparsify_vectors(jnp.asarray(x), a, 4, normalize=normalize,
                                               dense=dense),
                lambda a: tsp.sparsify_vectors(t(x), a, 4, normalize=normalize, dense=dense),
                attn, seed=7)


@pytest.mark.parametrize("length", [8, 512])
def test_top_one_ties_break_at_the_first_index(length):
    """k = 1 on equal values takes the first, as lax.top_k does: on all
    zeros (a dead attention) and on two equal peaks. torch.topk gave index
    6 of 8 zeros on the CPU, so k = 1 goes through torch.argmax."""
    x = np.zeros((3, 1, length), np.float32)
    x[1, 0, [length // 4, length // 2]] = 2.0
    vecs = normal((3, 4, length), 30)
    want = jsp.sparsify(jnp.asarray(x), 1, return_indices=True)
    got = tsp.sparsify(torch.from_numpy(x), 1, return_indices=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1][:, 0].tolist() == [0, length // 4, 0]
    jv = jsp.sparsify_vectors(jnp.asarray(vecs), jnp.asarray(x), 1)
    tv = tsp.sparsify_vectors(torch.from_numpy(vecs), torch.from_numpy(x), 1)
    np.testing.assert_array_equal(tv[1].numpy(), np.asarray(jv[1]))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv[0]))


@pytest.mark.parametrize("k", [2, 32])
def test_top_k_ties_keep_index_order(k):
    """k > 1 on equal values gives lax.top_k's indices: larger values
    first, equal ones lowest index first. The input is a song splat's range
    query, a 0/1 mask of 190 events with 34 in range (every value tied);
    torch.topk returned [92, 15, 96, ...] for lax.top_k's [2, 3, 11, ...]."""
    rng = np.random.default_rng(12)
    mask = np.zeros((2, 190), np.float32)
    for row in mask:
        row[rng.choice(190, 34, replace=False)] = 1.0
    mask[1, 7] = 2.0   # one larger value ahead of the ties
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(mask), k)
    t_vals, t_idx = tsp.topk._top_k(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    x = mask.reshape(2, 10, 19)
    want = jsp.sparsify(jnp.asarray(x), k, return_indices=True)
    got = tsp.sparsify(torch.from_numpy(x), k, return_indices=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for j, t in zip(jsp.sparsify2(jnp.asarray(x), k), tsp.sparsify2(torch.from_numpy(x), k)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    vecs = normal((2, 4, 190), 31)
    jv = jsp.sparsify_vectors(jnp.asarray(vecs), jnp.asarray(mask), k)
    tv = tsp.sparsify_vectors(torch.from_numpy(vecs), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(tv[1].numpy(), np.asarray(jv[1]))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv[0]))


def test_encourage_sparsity_loss_matches_mptpu():
    x = normal((2, 8, 32), 8)
    assert_same(lambda v: jsp.encourage_sparsity_loss(v, n_unpenalized=20),
                lambda v: tsp.encourage_sparsity_loss(v, n_unpenalized=20), x)


def test_to_key_points():
    """tests/test_inventory_extras.py:69, against mptpu with the gradient."""
    x = np.abs(normal((2, 16, 32), 9))
    (pts,) = assert_same(lambda v: jsp.to_key_points(v, n_to_keep=5),
                         lambda v: tsp.to_key_points(v, n_to_keep=5), x)
    assert pts.shape == (2, 5, 3)
    v = pts.numpy()
    assert (v[..., 1] >= 0).all() and (v[..., 1] <= 1).all()
    assert (v[..., 2] >= 0).all() and (v[..., 2] <= 1).all()


def module_pair(kind):
    if kind == "elementwise":
        jm = jsp.ElementwiseSparsity(model_dim=8, high_dim=32, keep=4)
        tm = tsp.ElementwiseSparsity(model_dim=8, high_dim=32, keep=4, device="cpu")
    elif kind == "elementwise_softmax":
        jm = jsp.ElementwiseSparsity(model_dim=8, high_dim=32, keep=4, use_softmax=True)
        tm = tsp.ElementwiseSparsity(model_dim=8, high_dim=32, keep=4, use_softmax=True,
                                     device="cpu")
    elif kind == "vectorwise":
        jm = jsp.VectorwiseSparsity(model_dim=8, keep=3, channels_last=False)
        tm = tsp.VectorwiseSparsity(model_dim=8, keep=3, channels_last=False, device="cpu")
    else:
        jm = jsp.VectorwiseSparsity(model_dim=8, keep=3, normalize=True)
        tm = tsp.VectorwiseSparsity(model_dim=8, keep=3, normalize=True, device="cpu")
    return jm, tm


@pytest.mark.parametrize("kind", ["elementwise", "elementwise_softmax", "vectorwise",
                                  "vectorwise_channels_last"])
def test_elementwise_and_vectorwise_sparsity(kind):
    """tests/test_inventory_extras.py:80 with mptpu's parameters copied
    across: outputs and the gradients into the input and the parameters."""
    jm, tm = module_pair(kind)
    x = normal((1, 32, 8) if kind == "vectorwise_channels_last" else (1, 8, 32), 10)
    params = jm.init(KEY, jnp.asarray(x))
    convert.module_from_flax(tm, params)
    outs = assert_same(lambda v: jm.apply(params, v), tm, x)
    if kind.startswith("elementwise"):
        assert outs[0].shape == (1, 8, 32) and int(torch.count_nonzero(outs[1])) == 4
    else:
        assert outs[0].shape == (1, 3, 8) and outs[1].shape == (1, 3)

    w = [normal(o.shape, 20 + i) for i, o in enumerate(outs) if o.is_floating_point()]
    j_gp = jax.grad(lambda p: sum(jnp.sum(o * wi) for o, wi in zip(jm.apply(p, jnp.asarray(x)), w)
                                  if jnp.issubdtype(o.dtype, jnp.floating)))(params)
    touts = [o for o in tm(t(x)) if o.is_floating_point()]
    sum((o * t(wi)).sum() for o, wi in zip(touts, w)).backward()
    for name, leaf in j_gp["params"].items():
        grad_close(getattr(tm, name).weight.grad.numpy(), np.asarray(leaf["kernel"]).T)
        grad_close(getattr(tm, name).bias.grad.numpy(), leaf["bias"])


SELECTIONS = ["sparse_softmax", "identity", "softmax", "relu"]


@pytest.mark.parametrize("selection_type", SELECTIONS + ["relu_leak_floor"])
def test_hard_choice_and_select_items_match_mptpu(selection_type):
    x = normal((3, 4, 10), 11)
    items = normal((10, 6), 12)
    kind = "relu" if selection_type == "relu_leak_floor" else selection_type
    knobs = (0.05, 0.01) if selection_type == "relu_leak_floor" else (0.0, 0.0)
    try:
        for mod in (jq, tq):
            mod.set_selection_leak(knobs[0])
            mod.set_selection_floor(knobs[1])
        assert_same(lambda v: jq.hard_choice(v, kind), lambda v: tq.hard_choice(v, kind), x)
        assert_same(lambda v: jq.select_items(v, jnp.asarray(items), kind),
                    lambda v: tq.select_items(v, t(items), kind), x, seed=3)
    finally:
        for mod in (jq, tq):
            mod.set_selection_leak(0.0)
            mod.set_selection_floor(0.0)


def test_gumbel_hard_choice_is_one_hot():
    x = t(normal((3, 4, 10), 13))
    out = tq.hard_choice(x, "gumbel_softmax", generator=torch.Generator().manual_seed(1))
    assert (torch.count_nonzero(out, dim=-1) == 1).all()
    assert torch.allclose(out.sum(-1), torch.ones(3, 4))
    with pytest.raises(ValueError, match="Generator"):
        tq.hard_choice(x, "gumbel_softmax")
    with pytest.raises(ValueError, match="unknown"):
        tq.hard_choice(x, "argmax")


def test_quantized_resonance_mixture_matches_mptpu():
    jm = jq.QuantizedResonanceMixture(16, 8, 256, 22050)
    params = jm.init(KEY)
    tm = tq.QuantizedResonanceMixture(16, 8, 256, 22050, device="cpu")
    tm.load_state_dict(convert.params_from_numpy(params, device="cpu"))
    x = normal((2, 3, 16), 14)
    outs = assert_same(lambda v: jm(params, v, return_code=True),
                       lambda v: tm(v, return_code=True), x)
    assert outs[1].shape == (2, 3, 256)
    close(tm(t(x)).detach().numpy(), jm(params, jnp.asarray(x)))


def test_waves_and_scale_match_mptpu():
    np.testing.assert_allclose(midi_to_hz([21, 69, 105.5]), [27.5, 440.0, 440 * 2 ** (36.5 / 12)])
    np.testing.assert_array_equal(musical_scale_hz(21, 106, 12), j_scale(21, 106, 12))
    f0s = musical_scale_hz(21, 106, 12).tolist()
    waves = make_waves(1024, f0s, 22050, device="cpu")
    assert waves.dtype == torch.float32 and waves.shape == (48, 1024)
    np.testing.assert_array_equal(waves.numpy(), np.asarray(j_make_waves(1024, f0s, 22050)))


@pytest.mark.parametrize("make", [
    lambda dev: tsp.ElementwiseSparsity(8, 32, 4, device=dev),
    lambda dev: tsp.VectorwiseSparsity(8, 3, device=dev),
    lambda dev: tq.QuantizedResonanceMixture(16, 8, 256, 22050, device=dev),
    lambda dev: make_waves(64, [440.0], 22050, device=dev),
], ids=["elementwise", "vectorwise", "quantized_mixture", "make_waves"])
def test_state_defaults_to_cuda(make):
    if torch.cuda.is_available():
        made = make(None)
        tensor = made if isinstance(made, torch.Tensor) else next(iter(made.state_dict().values()))
        assert tensor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)
