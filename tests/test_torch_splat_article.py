"""The splat's demonstration and article after the fit
(``mptpu_torch.models.splat_overfit.splat_article``) against
``scripts/splat.py``'s ``overfit_splat`` on JAX-CPU (``:95-126``), the
script loaded with ``importlib`` at 2^13 samples, 8 events, context 16 and
2 iterations (its ``--tiny`` widths), its segment patched to a seeded
signal. The port carries the script's fitted parameters
(``convert.splat_from_flax``) and its draws: the render's noise
``uniform(PRNGKey(0), (1, 1, n))`` and the perturbation
``uniform(PRNGKey(99), (1, 2, 16), -0.5, 0.5)``.

Tolerances: the max-normed reconstruction and perturbed render within
1e-4 of their largest (each is a sum of events within 1e-4 of theirs, as
in ``tests/test_torch_splat.py``); the spectrogram within 1e-4 of its
largest; the two articles' text equal once the audio data and the SVG
strip are taken out, and each article's audio within 2e-4 once decoded
(16-bit PCM of renders within 1e-4).
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from mptpu.models import OverfitHierarchicalEvents as JModel
from mptpu.ops import max_norm as j_max_norm
from mptpu.ops import stft as j_stft
from mptpu_torch import convert
from mptpu_torch.models import splat_overfit as so

ROOT = Path(__file__).resolve().parent.parent
N, SR, E, C, ITERS = 2**13, 22050, 8, 16, 2


def close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def script_fit(tmp_path_factory):
    """(the script's fitted parameters, its steps/s, its article, the
    target, the port's demonstration, the port's article)."""
    root = tmp_path_factory.mktemp("splat")
    t = np.arange(N) / SR
    target = (np.sin(2 * np.pi * 220 * t) * np.exp(-4 * t)
              + 0.05 * np.random.default_rng(3).standard_normal(N)).astype(np.float32)
    target /= np.abs(target).max()
    spec = importlib.util.spec_from_file_location("splat_script", ROOT / "scripts" / "splat.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.get_one_audio_segment = lambda n, sr, audio_path=None: jnp.asarray(target)
    params, sps = script.overfit_splat(n_samples=N, n_events=E, n_iterations=ITERS,
                                       article_path=str(root / "script.html"))
    model = convert.splat_from_flax(so.OverfitHierarchicalEvents(N, SR, E, C, device="cpu"),
                                    params)
    fit = so.SplatFit(model, [0.0] * ITERS, sps, 0)
    key = jax.random.PRNGKey(0)
    noise = np.array(jax.random.uniform(key, (1, 1, N), minval=-1.0, maxval=1.0))
    perturb = np.array(jax.random.uniform(jax.random.PRNGKey(99), (1, 2, C), minval=-0.5,
                                          maxval=0.5))
    demo = so.splat_article(fit, torch.from_numpy(target), str(root / "port.html"),
                            perturb=torch.from_numpy(perturb), noise=torch.from_numpy(noise))
    return (params, (root / "script.html").read_text(), target, demo,
            (root / "port.html").read_text(), perturb)


def test_reconstruction_and_perturbed_render_match_the_script(script_fit):
    params, _, _, demo, _, perturb = script_fit
    jm = JModel(n_samples=N, samplerate=SR, n_events=E, context_dim=C)
    key = jax.random.PRNGKey(0)
    recon = j_max_norm(jnp.sum(jm.apply(params, key)[0], axis=1, keepdims=True))
    perturbed = j_max_norm(jnp.sum(jm.apply(params, key, jnp.asarray(perturb))[0], axis=1,
                                   keepdims=True))
    close(demo.recon.numpy(), recon)
    close(demo.perturbed.numpy(), perturbed)
    assert np.abs(demo.perturbed.numpy() - demo.recon.numpy()).max() > 1e-3
    close(demo.spectrogram, np.asarray(j_stft(recon, 512, 256, pad=True))[0, 0].T)


def test_article_matches_the_scripts(script_fit):
    """The same title, intro (the fit's steps/s passed across), component
    titles and order; the audio of each component within 2e-4."""
    _, want_html, target, _, got_html, _ = script_fit
    want_text, want_numbers, want_audio, _ = chip_smoke.page_parts(want_html)
    got_text, got_numbers, got_audio, svgs = chip_smoke.page_parts(got_html)
    assert got_text == want_text and got_numbers == want_numbers
    assert "Perturbed event vectors" in got_text and len(svgs) == 1
    assert len(got_audio) == len(want_audio) == 3
    for g, w in zip(got_audio, want_audio):
        assert g.shape == w.shape == (N,)
        assert np.abs(g - w).max() <= 2e-4
    assert np.abs(got_audio[0] - target).max() <= 1 / 32767


def test_draws_default_to_a_seeded_generator():
    """Without draws, the perturbation and noise come from a generator
    seeded 99 on the model's device: two calls agree, the perturbation lies
    in [-0.5, 0.5)."""
    model = so.OverfitHierarchicalEvents(2**10, SR, 4, 8, device="cpu")
    fit = so.SplatFit(model, [], 1.0, 0)
    a = so.splat_article(fit, np.zeros(2**10, np.float32))
    b = so.splat_article(fit, np.zeros(2**10, np.float32))
    assert torch.equal(a.perturb, b.perturb) and torch.equal(a.recon, b.recon)
    assert a.perturb.shape == (1, 2, 8) and float(a.perturb.abs().max()) <= 0.5
