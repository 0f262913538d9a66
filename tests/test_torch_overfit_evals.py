"""The four SIAM checkpoint evaluations of the port
(``mptpu_torch.models.{overfit_refine_eval, overfit_diag,
overfit_stream_eval, holdout_anatomy}``) against their scripts run on
JAX-CPU (``scripts/overfit_refine_eval.py``, ``overfit_diag.py``,
``overfit_stream_eval.py``, ``holdout_anatomy.py``), each script loaded
with ``importlib`` and its ``main`` run with ``sys.argv`` on a run
directory of one seeded checkpoint: the port's parameters, written by
``mptpu``'s ``save_checkpoint`` as ``ckpt_000000007.pkl``, beside a
``metrics.json`` config line. The scripts write into the run directory; the
port writes into a directory of its own and leaves the run as it was.

``overfit_refine_eval.py`` and ``overfit_diag.py`` hard-code sw6's widths
(2^17 samples, 32 events, hidden 128, STFT 2048/256), so they run at those;
the walk runs at 2^13 samples, 4 events, hidden 32, context 16 (its flags),
with the gain re-fit, the alignment refinement, the pristine walk and a
two-window segment; the anatomy at ``--tiny``'s widths from its config
line, on the held-out dense corpus, which the script writes under its
working directory (a temporary one here) and the port then reads.

Tolerances: frames, shifts, lags and counts identical; every SNR within
0.01 dB; an LSD within 0.01 dB plus twice its float32 resolution on the
decode (``chip_smoke.lsd_resolution``); a PIF distance within rtol 1e-4
beyond the half unit of its fourth decimal; gains and energies within 1e-4
of their largest; the anatomy's correlations within 1e-3 (their fourth
decimal and float32 channels); its numpy helpers bit for bit.
"""

import faulthandler
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
import mptpu.sparse.quantize as jquantize
import mptpu.utils.platform as jplatform
from mptpu.data import datastore as jds
from mptpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mptpu_torch import convert
from mptpu_torch.models import holdout_anatomy as ha
from mptpu_torch.models import overfit_diag as od
from mptpu_torch.models import overfit_refine_eval as ore
from mptpu_torch.models import overfit_stream_eval as ose
from mptpu_torch.models import siam as ts
from mptpu_torch.models.codec_rate import segment, walk_target

ROOT = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(42)
FULL = dict(n_samples=2**17, context_dim=32, in_channels=1025, hidden_channels=128, n_events=32,
            transform_window_size=2048, transform_step_size=256)
WALK = dict(n_samples=2**13, context_dim=16, in_channels=1025, hidden_channels=32, n_events=4,
            transform_window_size=2048, transform_step_size=256)
WALK_FLAGS = dict(n_samples_log2=13, n_events=4, hidden=32, context_dim=16, audio_events=4,
                  stream_windows=2, gain_refit=1e-3, align_refine=64)
TINY = dict(n_samples=2**13, context_dim=16, in_channels=257, hidden_channels=32, n_events=4,
            transform_window_size=512, transform_step_size=256)
TINY_CONFIG = ("quality n_samples 2^13, 4 events, STFT 512/256, attn_floor 0.01, attn_leak 0.1, "
               "switch_clamp 20.0, residual_clamp 4.0, selection_leak 0.02, selection_floor 0.02, "
               "switch_bias_init 1.0, fixed_noise True, spectral_skip False")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def jax_noise(n_events, size, key=KEY):
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (1, 1, size), minval=-1.0,
                                      maxval=1.0)) for i in range(n_events)]))


def run_dir(root, name, widths, config):
    """A run directory of one seeded checkpoint (parameters from a CPU
    generator seeded 1) and ``config`` as its recorded config line."""
    run = root / name
    run.mkdir()
    model = ts.SIAMModel(**widths, generator=torch.Generator().manual_seed(1), device="cpu")
    j_save_checkpoint(str(run / "ckpt_000000007.pkl"), convert.module_to_flax(model), None, 7)
    (run / "metrics.json").write_text(json.dumps({"config": config, "eval": []}))
    return run


def run_script(name, flags):
    """``scripts/<name>.py``'s ``main`` with ``flags`` as its command line,
    its compilation cache stubbed, its watchdog cancelled and the selection
    knobs it sets for the process (``mptpu.sparse.quantize``) put back, so
    that later tests in this process see ``mptpu`` as a fresh process does."""
    kept, old_argv = jplatform.enable_compilation_cache, sys.argv
    knobs = (jquantize.RELU_SELECTION_LEAK, jquantize.RELU_SELECTION_FLOOR)
    jplatform.enable_compilation_cache = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                      ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.argv = [f"{name}.py"] + [f"--{k.replace('_', '-')}" + ("" if v is True else f"={v}")
                                     for k, v in flags.items()]
        mod.main()
    finally:
        sys.argv = old_argv
        faulthandler.cancel_dump_traceback_later()
        jplatform.enable_compilation_cache = kept
        jquantize.set_selection_leak(knobs[0])
        jquantize.set_selection_floor(knobs[1])
    return mod


def untouched(run, files):
    assert sorted(os.listdir(run)) == files


def near_db(got, want, tol=0.01):
    assert abs(got - want) <= tol, (got, want)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """The refinement and residual reports of one full-width run: (run,
    the scripts' refine_eval.json and diag.json, the port's reports, its
    output directory)."""
    root = tmp_path_factory.mktemp("full")
    run = run_dir(root, "run", FULL, "overfit n_samples 2^17, 32 events, STFT 2048/256")
    files = sorted(os.listdir(run))
    out = root / "port"
    noise = jax_noise(32, 8192)
    got_refine = ore.refine_eval(str(run), str(out), noise=noise, device="cpu", log=lambda s: None)
    got_diag = od.diag(str(run), str(out), noise=noise, device="cpu", log=lambda s: None)
    untouched(run, files)
    run_script("overfit_refine_eval", {"run": run})
    run_script("overfit_diag", {"run": run})
    want_refine = json.loads((run / "refine_eval.json").read_text())
    want_diag = json.loads((run / "diag.json").read_text())
    return run, want_refine, want_diag, got_refine, got_diag, out


def test_refine_eval_matches_the_script(full_run):
    """The raw, refit and aligned first-half SNRs within 0.01 dB, LSDs
    within 0.01 dB and twice their resolution, the alignment shifts
    identical, the refit gains within 1e-4 of their largest."""
    run, want, _, got, _, out = full_run
    assert set(got) == set(want)
    assert got["ckpt"] == want["ckpt"] and got["step"] == want["step"] == 7
    assert got["align_shifts"] == want["align_shifts"]
    g, w = np.asarray(got["refit_gains"]), np.asarray(want["refit_gains"])
    assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 5e-5
    n = 2**17
    target = torch.from_numpy(segment(n, 3)).reshape(1, 1, -1)[..., : n // 2]
    lsd_tol = 0.01 + 2 * chip_smoke.lsd_resolution(target, out / "recon_aligned_best.wav", 2048,
                                                   256)
    for kind in ("raw", "refit", "aligned"):
        near_db(got[f"{kind}_first_half_snr_db"], want[f"{kind}_first_half_snr_db"])
        near_db(got[f"{kind}_first_half_lsd_db"], want[f"{kind}_first_half_lsd_db"], lsd_tol)
    for k in ("gain_refit_ridge", "align_max_shift", "align_iters"):
        assert got[k] == want[k]


def test_diag_matches_the_script(full_run):
    """The residual split: SNRs within 0.01 dB, the gain and the schedule's
    largest value within 1e-4, the alive count identical, the energies and
    each quarter's error within 1e-4 of the target's energy."""
    _, _, want, _, got, _ = full_run
    assert set(got) == set(want)
    for k in ("wave_snr_db", "gain_adjusted_snr_db", "mag_spec_snr_db"):
        near_db(got[k], want[k])
    for k in ("optimal_gain", "sched_max"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])) + 5e-5, k
    assert got["alive_events"] == want["alive_events"]
    energy = want["target_energy_half"]
    assert abs(got["target_energy_half"] - energy) <= 1e-4 * energy
    for k in ("event_energy_top8", "event_energy_bottom8"):
        assert np.abs(np.asarray(got[k]) - np.asarray(want[k])).max() <= 1e-4 * energy, k
    for g, w in zip(got["err_by_quartile"], want["err_by_quartile"]):
        assert abs(g["err"] - w["err"]) <= 1e-4 * energy
        assert abs(g["tgt"] - w["tgt"]) <= 1e-4 * energy


def test_ports_writes_its_files_into_out(full_run):
    _, _, _, _, _, out = full_run
    assert sorted(os.listdir(out)) == ["diag.json", "recon_aligned_best.wav", "refine_eval.json"]


@pytest.fixture(scope="module")
def walk_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("walk")
    run = run_dir(root, "run", WALK, "overfit n_samples 2^13, 4 events, STFT 2048/256, "
                                     "spectral_skip False, spectral_filter False")
    files = sorted(os.listdir(run))
    flags = dict(WALK_FLAGS, pristine_windows=True)
    got = ose.stream_eval(str(run), str(root / "port"), noise=jax_noise(4, 8192), device="cpu",
                          log=lambda s: None, **flags)
    untouched(run, files)
    run_script("overfit_stream_eval", dict(flags, run=run))
    return json.loads((run / "stream_eval.json").read_text()), got, root / "port"


def test_stream_eval_matches_the_script(walk_run):
    """Every walk's SNRs within 0.01 dB, LSDs within 0.01 dB and twice
    their resolution, PIF distances within rtol 1e-4 and the half unit of
    the fourth decimal; the counts identical."""
    want, got, out = walk_run
    assert set(got) == set(want)
    assert {k for k in want if k.startswith("pristine")} and "refit_full_snr_db" in want
    seg = torch.from_numpy(segment(2**13, 3, 4, 2)).reshape(1, 1, -1)
    lsd_tol = 0.01 + 2 * chip_smoke.lsd_resolution(walk_target(seg, 2**13),
                                                   out / "recon_streaming.wav", 2048, 256)
    checked = 0
    for k, w in want.items():
        if k == "ckpt":
            assert got[k] == w
            continue
        if k.endswith("lsd_db"):
            near_db(got[k], w, lsd_tol)
        elif k.endswith("_db"):
            near_db(got[k], w)
        elif k.endswith("pif_dist"):
            assert abs(got[k] - w) <= 1e-4 * abs(w) + 5e-5, k
        else:
            assert got[k] == w, k
            continue
        checked += 1
    assert checked == 17
    assert sorted(os.listdir(out)) == ["recon_streaming.wav", "recon_streaming_pristine.wav",
                                       "recon_streaming_refit.wav", "stream_eval.json"]


@pytest.fixture(scope="module")
def anatomy_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("anatomy")
    run = run_dir(root, "run", TINY, TINY_CONFIG)
    saved = {k: os.environ.get(k) for k in ("MPTPU_CACHE", "AUDIO_PATH")}
    os.environ["MPTPU_CACHE"] = str(root / "cache")
    os.environ.pop("AUDIO_PATH", None)
    kept_collection, kept_cwd = jds._collection, os.getcwd()
    jds._collection = None
    os.chdir(root)
    try:
        # the script writes its held-out corpus under trained_weights/ of its working directory
        script = run_script("holdout_anatomy", {"run": run, "out": root / "script.json"})
        got = ha.anatomy(str(run), str(root / "port"),
                         holdout_dir=str(root / "trained_weights" / "dense_corpus_holdout"),
                         noise=jax_noise(4, 8192), device="cpu", log=lambda s: None)
    finally:
        os.chdir(kept_cwd)
        jds._collection = kept_collection
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return script, json.loads((root / "script.json").read_text()), got


def test_anatomy_matches_the_script(anatomy_run):
    """The four SNRs within 0.01 dB, the alive count and every lag
    identical, the correlations within 1e-3."""
    _, want, got = anatomy_run
    assert set(got) == set(want)
    assert got["n_alive_events"] == want["n_alive_events"] > 0
    for k in ("as_placed_snr_db", "oracle_gain_snr_db", "oracle_align_snr_db",
              "oracle_place_snr_db"):
        near_db(got[k], want[k])
    for k in ("rho_max_mean", "rho_chance_mean"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    for g, w in zip(got["events"], want["events"], strict=True):
        assert set(g) == set(w) and g["event"] == w["event"]
        assert abs(g["energy"] - w["energy"]) <= 1e-4 * max(r["energy"] for r in want["events"])
        if "lag" in w:
            assert g["lag"] == w["lag"]
            for k in ("rho0", "rho_max", "rho_chance"):
                assert abs(g[k] - w[k]) <= 1e-3, k
    assert got["config"] == want["config"] and got["checkpoint_step"] == 7


def test_anatomy_helpers_are_the_scripts_bit_for_bit(anatomy_run, tmp_path):
    """parse_run_config, xcorr_all_lags, snr_db and greedy_oracle on the
    same inputs give the script's values exactly."""
    script, _, _ = anatomy_run
    (tmp_path / "metrics.json").write_text(json.dumps({"config": TINY_CONFIG}))
    assert ha.parse_run_config(str(tmp_path)) == script.parse_run_config(str(tmp_path))
    rng = np.random.default_rng(5)
    target = rng.standard_normal(512).astype(np.float32)
    events = rng.standard_normal((3, 512)).astype(np.float32)
    events[1] = 0.0
    assert np.array_equal(ha.xcorr_all_lags(target, events[0]),
                          script.xcorr_all_lags(target, events[0]))
    assert ha.snr_db(target, events[0]) == script.snr_db(target, events[0])
    for lag in (None, 16, 511):
        assert ha.greedy_oracle(target, events, 256, lag) == script.greedy_oracle(
            target, events, 256, lag)


def test_newest_checkpoint(tmp_path):
    """``ckpt`` when given, else the last ``ckpt_*.pkl`` by name (never
    ``ema_best.pkl``); none raises."""
    with pytest.raises(FileNotFoundError):
        ore.newest_checkpoint(str(tmp_path))
    for name in ("ckpt_000000010.pkl", "ckpt_000000002.pkl", "ema_best.pkl"):
        (tmp_path / name).write_bytes(b"")
    assert ore.newest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_000000010.pkl")
    assert ore.newest_checkpoint(str(tmp_path), "x.pkl") == "x.pkl"


def test_unknown_flags_raise():
    with pytest.raises(TypeError):
        ore.refine_eval("run", "out", device="cpu", n_events=4)
    with pytest.raises(TypeError):
        od.diag("run", "out", device="cpu", gain_refit=1.0)


def test_siam_event_noise_is_jaxs_bit_for_bit():
    """``utils.jax_random`` (threefry2x32 in numpy): the fixed noise a
    trained checkpoint decodes with, ``fold_in`` and ``uniform`` of other
    shapes and ranges, each equal to ``jax.random``'s."""
    from mptpu_torch.utils import jax_random as jr

    assert np.array_equal(jr.siam_event_noise(32, 8192), jax_noise(32, 8192).numpy())
    for seed, data in ((0, 0), (99, 7), (2**32 - 1, 2**31 + 5)):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert jr.fold_in(jr.prng_key(seed), data) == (int(want[0]), int(want[1]))
    want = jax.random.uniform(jax.random.PRNGKey(99), (1, 2, 16), minval=-0.5, maxval=0.5)
    assert np.array_equal(jr.uniform(jr.prng_key(99), (1, 2, 16), -0.5, 0.5), np.asarray(want))
    want = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(3), 11), (5, 7))
    assert np.array_equal(jr.uniform(jr.fold_in(jr.prng_key(3), 11), (5, 7)), np.asarray(want))


def test_refine_eval_in_float64(tmp_path):
    """``dtype=torch.float64`` runs the model and the segment in float64
    (phase 15 reads the float32 LSD's distance from it): the same shifts,
    SNRs within 0.01 dB, and a float64 decode written."""
    run = run_dir(tmp_path, "run", WALK, "overfit n_samples 2^13, 4 events, STFT 2048/256")
    widths = dict(n_samples=2**13, n_events=4, hidden=32, context_dim=16)
    noise = jax_noise(4, 8192)
    r32 = ore.refine_eval(str(run), str(tmp_path / "a"), noise=noise, device="cpu",
                          widths=widths, log=lambda s: None)
    keep = {}
    r64 = ore.refine_eval(str(run), str(tmp_path / "b"), noise=noise, device="cpu",
                          widths=widths, keep=keep, dtype=torch.float64, log=lambda s: None)
    assert keep["channels"].dtype == torch.float64
    assert r64["align_shifts"] == r32["align_shifts"]
    for k in ("raw", "refit", "aligned"):
        near_db(r64[f"{k}_first_half_snr_db"], r32[f"{k}_first_half_snr_db"])
