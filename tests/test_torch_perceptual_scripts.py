"""The phase-invariance study and texture synthesis (the entry points of
``scripts/phaseinvariance.py`` and ``scripts/texture.py``), their report
helpers ``utils/{playable,reporting}.py``, and the rehearsal of
``chip_smoke.py``'s phase 12, in the port against ``mptpu`` on JAX-CPU.
Each entry point takes one Adam step against its script's step at the
script's small size (``phaseinvariance --smoke``, each transform;
``texture --tiny``, both feature sets), the texture step restated from
the script's lines, which live inside its ``main``.

Tolerances: forwards rtol 1e-5 / atol 1e-6 (outputs made by FFTs at atol
1e-6 of their peak); gradients within 1e-4 of each leaf's largest; one
Adam step's loss rtol 1e-5 and its parameters within 1e-3 of the learning
rate of optax's. Wider, each measured where it is used: the AIM's loss (a
float32 mean of millions of squared differences in XLA) and the samples
whose gradient stands at its noise.
"""

import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.ops.norms import max_norm as j_max_norm
from mptpu.ops.stft import stft as j_stft
from mptpu.perceptual.aim import auditory_image_model as j_aim
from mptpu.perceptual.gammatone import gammatone_filter_bank as j_gammatone
from mptpu.perceptual.scattering import scattering_transform as j_scattering
from mptpu.perceptual.texture import AudioTextureFeatures as JTexture
from mptpu_torch.models import phaseinvariance as tpi
from mptpu_torch.models import texture as ttex
from mptpu_torch.train.optim import Adam

REPO = Path(__file__).resolve().parent.parent
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4
KEY = jax.random.PRNGKey(0)


def load_script(name):
    """``scripts/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


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


def close(port, want, to_peak=False):
    want = np.asarray(want)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == want.shape
    atol = 1e-6 * np.abs(want).max() if to_peak else FWD["atol"]
    np.testing.assert_allclose(port, want, rtol=FWD["rtol"], atol=atol)


def leaf_close(port, want, where=""):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(port - want).max() <= GRAD * scale, (
        f"{where}: {np.abs(port - want).max() / scale:.2e} of the largest")


# ---- models/phaseinvariance.py


@pytest.fixture(scope="module")
def phase_script():
    return load_script("phaseinvariance")


def test_phaseinvariance_metrics(phase_script):
    target = tpi.phaseinvariance_target(2**13)
    from mptpu.data.synthetic import synthetic_audio

    np.testing.assert_array_equal(target, synthetic_audio(2**13, 22050, n_events=4, seed=0,
                                                          sustained=True))
    recon = target * 0.5 + rand(2**13, seed=30, scale=0.01)
    a, b = t(target).reshape(1, 1, -1), t(recon).reshape(1, 1, -1)
    ja, jb = jnp.asarray(target).reshape(1, 1, -1), jnp.asarray(recon).reshape(1, 1, -1)
    np.testing.assert_allclose(tpi.snr_db(a, b), phase_script.snr_db(ja, jb), rtol=1e-5)
    np.testing.assert_allclose(tpi.lsd_db(a, b), phase_script.lsd_db(ja, jb), rtol=1e-5)


@pytest.mark.parametrize("name", tpi.TRANSFORMS)
def test_phaseinvariance_step_at_smoke_size(phase_script, name):
    """``--smoke`` (2^13 samples): one step of ``reconstruct_with_transform``
    in each package from ``mptpu``'s start (uniform in [-1e-3, 1e-3) from
    ``PRNGKey(0)``), the port's start passed in."""
    target = jnp.asarray(tpi.phaseinvariance_target(2**13)).reshape(1, 1, -1)
    fb = j_gammatone(n_filters=128, size=256, band_spacing="geometric")
    jtransform = {"mag_spec_512": lambda x: j_stft(x, 512, 256, pad=True),
                  "mag_spec_2048": lambda x: j_stft(x, 2048, 256, pad=True),
                  "aim": lambda x: j_aim(x, fb, 256, 64)}[name]
    jrecon, jlosses = phase_script.reconstruct_with_transform(target, jax.jit(jtransform), 1)
    init = jax.random.uniform(KEY, target.shape, minval=-1e-3, maxval=1e-3)
    transform = tpi.transforms("cpu")[name]
    run = tpi.reconstruct_with_transform(t(target), transform, 1, init=t(init))
    jg = np.asarray(jax.grad(lambda a: jnp.mean((jtransform(a) - jtransform(target)) ** 2))(init))
    x = t(init).requires_grad_()
    (g,) = torch.autograd.grad(torch.mean((transform(x) - transform(t(target))) ** 2), x)
    leaf_close(g.numpy(), jg, "the gradient by the samples")
    # the loss is a float32 mean of 2.1M squared differences at this size;
    # XLA's read 202.1532 where the float64 sum reads 202.1568 (1.8e-5
    # below; the port's 1e-8), so the losses hold at rtol 3e-5
    np.testing.assert_allclose(run.losses, jlosses, rtol=3e-5)
    np.testing.assert_allclose(run.step_losses, jlosses, rtol=3e-5)
    # Adam's first step is lr x the gradient's sign, whatever its size: the
    # samples whose gradient stands under 1e-4 of the largest (the AIM's
    # rectifier leaves some at its noise) may step either way
    sure = np.abs(jg) > 1e-4 * np.abs(jg).max()
    np.testing.assert_allclose(run.audio.numpy()[sure], np.asarray(jrecon)[sure], rtol=0,
                               atol=1e-3 * 1e-2)
    assert sure.mean() > 0.99 and float(jnp.abs(jrecon - init).max()) > 0.5 * 1e-2


def test_run_phaseinvariance_writes_its_report(tmp_path):
    out = tmp_path / "pi"
    results = tpi.run_phaseinvariance(iterations=2, n_samples=2**12, out=str(out), device="cpu",
                                      log=lambda s: None)
    assert list(results) == list(tpi.TRANSFORMS)
    for name, r in results.items():
        assert len(r["run"].step_losses) == 2 and np.isfinite(r["snr_db"])
        assert (out / f"recon_{name}.wav").exists()
    import json

    metrics = json.loads((out / "metrics.json").read_text())
    assert set(metrics["aim"]) == {"final_loss", "snr_db", "lsd_db"}
    page = (out / "report.html").read_text()
    assert page.count("<audio controls") == 4 and "Phase-invariant features" in page


# ---- models/texture.py


@pytest.fixture(scope="module")
def texture_target():
    return np.asarray(j_max_norm(jnp.asarray(rand(1, 1, 2**12, seed=31))))


@pytest.mark.parametrize("features", ["texture", "scattering"])
def test_texture_script_step_at_tiny(texture_target, features, tmp_path):
    """``--tiny`` (2^12 samples, 16 filters): the script's jitted step
    (``scripts/texture.py:86-94``) from its start (0.01 x a normal draw from
    ``PRNGKey(0)``) against ``texture_step``, then ``synthesize_texture``'s
    two steps against two of the script's."""
    n = 2**12
    target = jnp.asarray(texture_target)
    if features == "texture":
        feats = JTexture(n, n_filters=16, filter_size=64, min_band_size=512)
        featurize = feats
    else:
        bank = jnp.asarray(j_gammatone(16, 128, band_spacing="geometric"))

        def featurize(x):
            c1, c2 = j_scattering(x.reshape(x.shape[0], -1), bank)
            return jnp.concatenate([c1.reshape(x.shape[0], -1), c2.reshape(x.shape[0], -1)], -1)

    target_features = featurize(target)
    params = jax.random.normal(KEY, target.shape) * 0.01
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s):
        def loss_fn(q):
            return jnp.abs(featurize(j_max_norm(q)) - target_features).sum()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    p1, s1, l0 = step(params, opt.init(params))
    _, _, l1 = step(p1, s1)
    tf = ttex.texture_featurizer(features, n, tiny=True, device="cpu")
    tfeat = tf(t(texture_target))
    close(tfeat, target_features, to_peak=True)
    x = t(params).requires_grad_()
    adam = Adam(1e-3)
    loss, _ = ttex.texture_step(x, adam, adam.init([x]), tf, tfeat)
    np.testing.assert_allclose(float(loss), float(l0), rtol=1e-5)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(p1), rtol=0, atol=1e-3 * 1e-3)
    run = ttex.synthesize_texture(iterations=2, tiny=True, features=features, log_every=1,
                                  target=t(texture_target), init=t(params),
                                  out=str(tmp_path / "tex"), device="cpu", log=lambda s: None)
    np.testing.assert_allclose(run.losses, [float(l0), float(l1)], rtol=1e-5)
    for f in ("recon.wav", "target.wav"):
        assert (tmp_path / "tex" / f).exists()
    from mptpu_torch.obs import Collection

    dash = Collection(str(tmp_path / "tex" / "dashboard"))
    assert sorted(dash.names()) == ["loss", "recon", "target"]
    np.testing.assert_allclose(np.asarray(dash.latest("loss")), run.losses, rtol=1e-6)


# ---- utils/playable.py, utils/reporting.py


def test_report_helpers_match_mptpus():
    jplayable = importlib.import_module("mptpu.utils.playable")
    jreporting = importlib.import_module("mptpu.utils.reporting")
    playable = importlib.import_module("mptpu_torch.utils.playable")
    reporting = importlib.import_module("mptpu_torch.utils.reporting")
    x = np.sin(np.linspace(0, 300, 4000)) * 1.3
    assert playable.encode_audio(x) == jplayable.encode_audio(x)
    np.testing.assert_array_equal(playable.playable(torch.from_numpy(x)), jplayable.playable(x))
    sections = [("Source", reporting.audio_element(x, 22050, "a <b>")), ("Two words", "<p/>")]
    assert reporting.html_page("T & t", sections) == jreporting.html_page("T & t", sections)
    assert reporting.audio_data_url(x) == jreporting.audio_data_url(x)


def test_phase_12_rehearsal_on_the_cpu():
    """chip_smoke.py's phase 12 at its rehearsal sizes on the CPU, where
    the card's side is the CPU too: every gate it runs on a card runs here,
    the trajectories against mptpu's recorded at those sizes (the demo
    corpus written under a temporary MPTPU_CACHE)."""
    import chip_smoke

    chip_smoke.perceptual_phase(torch.device("cpu"), chip_smoke.PERCEPTUAL_SMALL, lambda: None)
