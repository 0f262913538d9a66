"""The report pages of the port (``mptpu_torch.models.report`` and
``report_generalization``) against ``scripts/report.py`` and
``scripts/report_generalization.py`` on JAX-CPU, each script loaded with
``importlib``:

- ``make_report`` at ``--tiny``'s widths with the walk and a metrics
  table, on a seeded checkpoint (the port's parameters written by
  ``mptpu``'s ``CheckpointManager`` naming) and a seeded corpus segment
  under a temporary ``MPTPU_CACHE``, the port fed ``mptpu``'s noise (event
  ``i`` of the window from ``fold_in(PRNGKey(0), i)``, window ``w`` of the
  walk from ``fold_in(fold_in(PRNGKey(0), w), i)``);
- ``make_overfit_report`` on a run directory holding every file it reads
  (sw6's committed ``metrics.json``, seeded WAVs, the three evaluations'
  JSON files), ``make_songsplat_report`` on seeded song files;
- the generalization page of two runs, one with a loss trajectory.

Tolerances: the pages' text equal once the audio data and the SVG strips
are taken out (the tables as text); the audio within 2e-4 of full scale
once decoded (16-bit PCM of decodes within 1e-4); each spectrogram strip's
cells equal in place and within 2 of 255 in colour but for 1% of them
(colours quantize the log spectrum); the event scatter's coordinates
within 0.5 of its 400 x 200 (each is the first principal component of
four event vectors within 1e-4, normalized to the plot; 0.2 apart
measured); the generalization page byte for byte.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from mptpu.data import datastore as jds
from mptpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mptpu_torch import convert
from mptpu_torch.data.synthetic import ensure_demo_dataset, synthetic_audio
from mptpu_torch.models import report as rp
from mptpu_torch.models import report_generalization as rg
from mptpu_torch.utils.wav import write_wav

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_pages_match(got, want):
    """``chip_smoke.pages_match`` with every number equal: the text without
    audio data and SVG, the audio, the SVGs (strips by their cells, the
    scatter by its coordinates)."""
    chip_smoke.pages_match("page", got, want, 0.0)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.setattr(jds, "_collection", None)
    return tmp_path


def test_make_report_matches_the_script(cache):
    """``--tiny --streaming`` with a metrics table and a seeded segment."""
    corpus = ensure_demo_dataset(str(cache / "corpus"), n_files=2, seconds=2.0)
    ckpts = cache / "ckpt"
    ckpts.mkdir()
    model = rp.report_model(tiny=True, device="cpu")
    j_save_checkpoint(str(ckpts / "ckpt_000000005.pkl"), convert.module_to_flax(model), None, 5)
    metrics = cache / "metrics.json"
    metrics.write_text(json.dumps({
        "config": "quality n_samples 2^13", "init_s": 1.5, "first_step_s": 2.25,
        "ms_per_step_synced": 12.5, "ms_per_step_pipelined": 11.0,
        "eval": [{"step": s, "holdout_snr_db": 0.1 * s, "holdout_lsd_db": 30 - s,
                  "recon_rms": 0.01 * s} for s in (4, 8)]}))
    script = load_script("report")
    script.make_report(str(ckpts), str(cache / "script.html"), tiny=True, streaming=True,
                       audio_path=corpus, seed=5, metrics_path=str(metrics))
    key = jax.random.PRNGKey(0)

    def draws(k, n):
        return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, i), (1, 1, 8192),
                                                       minval=-1.0, maxval=1.0))
                         for i in range(n)])

    noise = torch.from_numpy(draws(key, 4))
    stream_noise = torch.from_numpy(np.stack([draws(jax.random.fold_in(key, w), 4)
                                              for w in range(6)]))
    comps = rp.make_report(str(ckpts), str(cache / "port.html"), tiny=True, streaming=True,
                           audio_path=corpus, seed=5, metrics_path=str(metrics), noise=noise,
                           stream_noise=stream_noise, device="cpu", log=lambda s: None)
    assert [type(c).__name__ for c in comps] == ["AudioComponent"] * 2 + [
        "ImageComponent", "_SvgComponent", "_TableComponent", "AudioComponent"]
    assert_pages_match((cache / "port.html").read_text(), (cache / "script.html").read_text())


def overfit_run(root):
    """A run directory with every file ``make_overfit_report`` reads."""
    run = root / "run"
    run.mkdir()
    n = 2**13
    for i, name in enumerate(("target", "recon_best", "recon_aligned_best", "recon_streaming",
                              "recon_streaming_refit", "recon_streaming_pristine",
                              "recon_wire_f16")):
        write_wav(str(run / f"{name}.wav"), synthetic_audio(n, seed=20 + i) * 0.5, 22050)
    metrics = json.loads((ROOT / "trained_weights" / "siam_overfit_full_sw6" /
                          "metrics.json").read_text())
    (run / "metrics.json").write_text(json.dumps(metrics))
    (run / "refine_eval.json").write_text(json.dumps({
        "raw_first_half_snr_db": 0.132, "refit_first_half_snr_db": 1.5,
        "aligned_first_half_snr_db": 6.557}))
    (run / "stream_eval.json").write_text(json.dumps({
        "streaming_full_snr_db": 0.02, "streaming_first_half_snr_db": 0.03,
        "refit_full_snr_db": 4.25, "refit_first_half_snr_db": 5.0,
        "pristine_full_snr_db": 3.5, "pristine_second_half_snr_db": 2.0}))
    (run / "codec_rate.json").write_text((ROOT / "trained_weights" / "siam_overfit_full_sw6" /
                                          "codec_rate.json").read_text())
    return run


def test_overfit_report_matches_the_script(tmp_path):
    run = overfit_run(tmp_path)
    script = load_script("report")
    script.make_overfit_report(str(run), str(tmp_path / "script.html"))
    comps = rp.make_overfit_report(str(run), str(tmp_path / "port.html"), log=lambda s: None)
    assert len(comps) == 10
    got, want = (tmp_path / "port.html").read_text(), (tmp_path / "script.html").read_text()
    assert "PRISTINE" in got and "QUANTIZED" in got and "aligned 6.557 dB" in got
    assert_pages_match(got, want)


def test_overfit_report_without_evaluations(tmp_path):
    """Only the trainer's own files: the two WAVs, the spectrograms and the
    table."""
    run = overfit_run(tmp_path)
    for name in os.listdir(run):
        if name not in ("target.wav", "recon_best.wav", "metrics.json"):
            os.remove(run / name)
    script = load_script("report")
    script.make_overfit_report(str(run), str(tmp_path / "script.html"))
    comps = rp.make_overfit_report(str(run), str(tmp_path / "port.html"), log=lambda s: None)
    assert len(comps) == 5
    assert_pages_match((tmp_path / "port.html").read_text(),
                       (tmp_path / "script.html").read_text())


def test_songsplat_report_matches_the_script(tmp_path):
    run = tmp_path / "song"
    run.mkdir()
    write_wav(str(run / "song_target.wav"), synthetic_audio(2**14, seed=30), 22050)
    write_wav(str(run / "song_recon.wav"), synthetic_audio(2**14, seed=31) * 0.3, 22050)
    (run / "song_eval.json").write_text(json.dumps({
        "covered_snr_db": 0.012, "covered_lsd_db": 38.824, "trained_steps": 2000,
        "refit_ridge": 1e-4}))
    script = load_script("report")
    script.make_songsplat_report(str(run), str(tmp_path / "script.html"))
    rp.make_songsplat_report(str(run), str(tmp_path / "port.html"), log=lambda s: None)
    assert_pages_match((tmp_path / "port.html").read_text(),
                       (tmp_path / "script.html").read_text())


def quality_metrics(seed, with_losses):
    rng = np.random.default_rng(seed)
    evals = [{"step": s, "first_half_lsd_db": float(30 - 0.001 * s + rng.normal()),
              "holdout_snr_db": float(rng.normal()), "first_half_pif_dist": float(rng.random()),
              "holdout_lsd_db": float(25 + rng.normal())} for s in range(1000, 21000, 1000)]
    losses = [[s, float(100 / (1 + s) + rng.random())] for s in range(0, 20000, 50)]
    return {"config": "quality", "eval": evals, "losses": losses if with_losses else []}


def test_generalization_report_is_the_scripts_byte_for_byte(tmp_path, monkeypatch):
    runs = {"fixed": quality_metrics(1, True), "fresh": quality_metrics(2, False)}
    for name, m in runs.items():
        (tmp_path / "trained_weights" / name).mkdir(parents=True)
        (tmp_path / "trained_weights" / name / "metrics.json").write_text(json.dumps(m))
    script = load_script("report_generalization")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["report_generalization.py", "--runs",
                                      "fixed:fixed corpus,fresh:fresh corpus,absent:x",
                                      "--out", str(tmp_path / "script.html")])
    script.main()
    comps = rg.make_generalization_report(
        [(str(tmp_path / "trained_weights" / d), label) for d, label in
         (("fixed", "fixed corpus"), ("fresh", "fresh corpus"), ("absent", "x"))],
        str(tmp_path / "port.html"), log=lambda s: None)
    assert len(comps) == 8
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "script.html").read_bytes()


def test_generalization_report_without_runs_raises(tmp_path):
    with pytest.raises(ValueError):
        rg.make_generalization_report([(str(tmp_path / "none"), "")], str(tmp_path / "x.html"),
                                      log=lambda s: None)
