"""The eleven remaining command lines (ROADMAP A12b,
``tests/test_torch_scripts_cli.py:A12B``, whose parsers that file holds to
the scripts') and ``train_siam --data-parallel`` across ranks, on the CPU.

- Keywords: each ``main(argv)`` with the port function it calls replaced
  by a recorder, at the defaults and with each flag given another value,
  one flag at a time: the call carries what the script's own parser makes
  of the same argv (``mptpu``'s fixed-noise draws where the script decodes
  with a fixed key).
- Runs: each ``main([... , "--device", "cpu"])`` at ``--tiny`` / ``--smoke``
  or with its counts cut, in a working directory of its own: exit code,
  printed lines, the files of ``chip_smoke.cli_required`` (the table phase
  17 holds the card's runs to), the failing exits the scripts have; for
  ``siam_overfit`` the stall watchdog re-armed at each progress line,
  ``--resume`` and the refused ``--commit-artifacts``.
- ``roomsim --n-frames 64`` against ``scripts/roomsim.py`` on JAX-CPU: the
  recording's 16-bit samples within one step, the energy frames within
  1e-6 of their peak (``tests/test_torch_longtail.py``'s FFT tolerance).
- ``train_siam --data-parallel`` on two gloo ranks started as a launcher
  starts them (``chip_smoke.train_siam_ranks``): parameters identical bit
  for bit across the ranks, losses within 1e-3 relative of one process on
  the whole batch (float32 sums in another order, ROADMAP C), files written
  by rank 0 alone.
- The checkout's tracked files are unchanged at the end.
"""

import argparse
import faulthandler
import functools
import json
import os
import re
import runpy
import wave
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mptpu_torch import convert
from mptpu_torch.models import siam as ts
from mptpu_torch.train.checkpoint import save_checkpoint
from mptpu_torch.utils import jax_random
from test_torch_scripts_cli import (A12B, ROOT, Spy, files, port_module, run_main, script_parser,
                                    tracked_files)

parser_of = functools.lru_cache(maxsize=None)(script_parser)
# a tiny SIAM model at the evaluations' window (2048 / 256)
CFG = dict(n_samples=2**13, context_dim=16, in_channels=1025, hidden_channels=32, n_events=4,
           transform_window_size=2048, transform_step_size=256, fft_resonance=True,
           attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0, switch_clamp=20.0,
           residual_clamp_scale=4.0, encoder_clamp=1e4)
CONFIG = ("overfit 1 segment seed 3, n_samples 2^13, 4 events, STFT 2048/256, lr 0.0003, "
          "attn_floor 0.01, attn_leak 0.1, fixed_noise True, switch_bias_init 1.0, "
          "selection_leak 0.02, selection_floor 0.02")
TINY_WIDTHS = dict(n_samples=2**13, n_events=4, hidden=32, context_dim=16)


@pytest.fixture(scope="module", autouse=True)
def checkout():
    """The tracked files before the module's first test."""
    return tracked_files()


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One demo corpus (MPTPU_CACHE) for the module."""
    return tmp_path_factory.mktemp("cache")


@pytest.fixture
def work(tmp_path, cache, monkeypatch):
    """A working directory of its own, the module's corpus, no reference
    implementation, and no watchdog left armed afterwards."""
    monkeypatch.setenv("MPTPU_CACHE", str(cache))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.delenv("MPTPU_REFERENCE", raising=False)
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    faulthandler.cancel_dump_traceback_later()


def seeded_run(path, step=7):
    """A run directory: tiny seeded SIAM parameters as ``ckpt_<step>.pkl``
    and a config line recording them."""
    path.mkdir(parents=True)
    model = ts.SIAMModel(**CFG, generator=torch.Generator().manual_seed(1), device="cpu")
    save_checkpoint(str(path / f"ckpt_{step:09d}.pkl"), convert.module_to_flax(model), None, step)
    (path / "metrics.json").write_text(json.dumps({"config": CONFIG, "eval": []}))
    return path


# ---- keywords: what main passes for the script's parsed flags

def changed(action) -> list:
    """An argv giving ``action`` a value other than its default."""
    opt, d = action.option_strings[0], action.default
    if isinstance(action, argparse._StoreTrueAction):
        return [opt]
    if action.type is int:
        return [opt, str(3 if d is None else d + 1)]
    if action.type is float:
        return [opt, str(d * 2 if d else 0.5)]
    return [opt, f"{d}_changed" if d else "changed"]


def noise(n_events, n_samples, seed):
    return jax_random.siam_event_noise(n_events, min(8192, n_samples), seed=seed)


def expected_calls(name, ns) -> dict:
    """{port function: (args, keywords but ``device`` and the callbacks)}
    that ``main`` must make for the script's parsed flags ``ns``."""
    v = dict(vars(ns))
    if name == "siam_overfit":
        if v["commit_artifacts"]:
            return {}   # refused before any call
        kw = {k: x for k, x in v.items() if k not in ("stall_s", "commit_artifacts")}
        n_samples = 2 ** v["n_samples_log2"] if v["n_samples_log2"] else (
            2**13 if v["tiny"] else 2**17)
        events = v["n_events"] or (4 if v["tiny"] else 32)
        kw["noise"] = noise(events, n_samples, 42) if v["fixed_noise"] else None
        return {"overfit_siam": ((), kw)}
    if name in ("overfit_refine_eval", "overfit_diag"):
        # the script's model: 2^17 samples, 32 events, its fixed-noise key
        kw = {k: x for k, x in v.items() if k not in ("run", "watchdog_s")}
        kw["noise"] = noise(32, 2**17, v.get("noise_seed", 42))
        fn = "refine_eval" if name == "overfit_refine_eval" else "diag"
        return {fn: ((v["run"], v["run"]), kw)}
    if name == "holdout_anatomy":
        out = v["out"] or os.path.join(v["run"], "anatomy.json")
        return {"anatomy": ((v["run"], os.path.dirname(out) or "."), dict(
            holdout_dir="trained_weights/dense_corpus_holdout", align=v["align"], path=out,
            noise=noise(4, 2**13, 42)))}   # the fixture run's config: fixed noise
    if name == "report_generalization":
        runs = []
        for spec in v["runs"].split(","):
            d, _, label = spec.partition(":")
            runs.append((d, label))
        return {"make_generalization_report": ((runs, v["out"]), dict(root="trained_weights"))}
    if name == "multiband_parity":
        return {"parity_trajectory": ((v["iterations"],), dict(
            reference=None, steps=v["steps"], batch_size=v["batch_size"]))}
    if name == "roomsim":
        calls = {"simulate_room": ((v["block_size"], v["n_frames"], v["width"], v["height"],
                                    v["depth"], v["samplerate"], v["seed"]), dict(out=v["out"]))}
        if v["overfit_steps"]:
            calls["overfit_room"] = ((torch.ones(1, 1, 8) / (1 + 1e-9),), dict(
                room_size=v["width"], voxel_size=v["block_size"], n_frames=v["n_frames"],
                steps=v["overfit_steps"], seed=v["seed"]))
        return calls
    fn = {"audiooperator": "train_audiooperator", "funcsong": "train_funcsong",
          "textural": "train_textural", "phaseinvariance": "run_phaseinvariance"}[name]
    return {fn: ((), v)}


# the port functions each command line calls, with what a recorder returns in their place
STUBS = {
    "siam_overfit": {"mptpu_torch.models.siam_overfit.overfit_siam": SimpleNamespace(metrics={})},
    "overfit_refine_eval": {"mptpu_torch.models.overfit_refine_eval.refine_eval": {}},
    "overfit_diag": {"mptpu_torch.models.overfit_diag.diag": {}},
    "holdout_anatomy": {"mptpu_torch.models.holdout_anatomy.anatomy": {}},
    "report_generalization": {
        "mptpu_torch.models.report_generalization.make_generalization_report": []},
    "multiband_parity": {"mptpu_torch.models.multiband_parity.parity_trajectory": dict(
        config="c", rows=[dict(iteration=0, ours_snr_db=1.0, ours_learn_s=0.0)], wall_s=0.0)},
    "audiooperator": {"mptpu_torch.models.audiooperator.train_audiooperator": None},
    "funcsong": {"mptpu_torch.models.funcsong.train_funcsong": None},
    "textural": {"mptpu_torch.models.textural.train_textural": None},
    "roomsim": {"mptpu_torch.gen.roomsim.simulate_room": SimpleNamespace(
        recording=torch.ones(8), seconds=0.0),
        "mptpu_torch.gen.roomsim.overfit_room": SimpleNamespace(losses=[1.0])},
    "phaseinvariance": {"mptpu_torch.models.phaseinvariance.run_phaseinvariance": None},
}
CALLBACKS = ("device", "log", "sync", "on_row")


def same(a, b) -> bool:
    if isinstance(a, (np.ndarray, torch.Tensor)) or isinstance(b, (np.ndarray, torch.Tensor)):
        return a is not None and b is not None and np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("name", A12B)
def test_main_passes_the_scripts_flags(name, work, monkeypatch):
    """At the defaults and with each flag changed alone: the calls ``main``
    makes carry what the script's parser makes of the argv."""
    import importlib

    parser = parser_of(name)
    for d in ("trained_weights/siam_quality_fresh", "trained_weights/siam_quality_fresh_changed"):
        os.makedirs(d, exist_ok=True)   # holdout_anatomy reads the run's config line first
        Path(d, "metrics.json").write_text(json.dumps({"config": CONFIG}))
    calls = {}
    for target, value in STUBS[name].items():
        module_name, fn = target.rsplit(".", 1)

        def recorder(*args, _fn=fn, _value=value, **kwargs):
            calls[_fn] = (args, kwargs)
            return _value

        monkeypatch.setattr(importlib.import_module(module_name), fn, recorder)
    argvs = [[]] + [changed(a) for a in parser._actions if a.option_strings and a.dest != "help"]
    for argv in argvs:
        calls.clear()
        want = expected_calls(name, parser.parse_args(argv))
        code = port_module(name).main(argv + ["--device", "cpu"])
        faulthandler.cancel_dump_traceback_later()
        assert code == (0 if want else 1), argv
        assert set(calls) == set(want), (argv, set(calls))
        for fn, (args, kwargs) in want.items():
            got_args, got_kwargs = calls[fn]
            assert len(got_args) == len(args) and all(map(same, got_args, args)), (argv, fn)
            # the generalization page is drawn from files alone: nothing runs on a device
            assert got_kwargs.get("device") == (None if name == "report_generalization"
                                                else "cpu"), (argv, fn)
            got = {k: x for k, x in got_kwargs.items() if k not in CALLBACKS}
            assert set(got) == set(kwargs), (argv, fn, set(got) ^ set(kwargs))
            for k, x in kwargs.items():
                assert same(got[k], x), (argv, fn, k, got[k], x)


# ---- runs

def test_siam_overfit_runs_resumes_and_refuses_commits(work, monkeypatch, capsys):
    """``--tiny --fixed-noise`` for 3 steps: its files, the stall watchdog
    armed at ``--watchdog-s`` and re-armed at ``--stall-s`` at the one
    progress line; ``--resume`` continues from the checkpoint's step;
    ``--commit-artifacts`` exits 1 before any step and writes nothing."""
    from mptpu_torch.models import siam_overfit as m

    armed = []
    monkeypatch.setattr(faulthandler, "dump_traceback_later",
                        lambda t, exit=False: armed.append(("arm", t)))
    monkeypatch.setattr(faulthandler, "cancel_dump_traceback_later",
                        lambda: armed.append(("cancel",)))
    argv = ["--tiny", "--fixed-noise", "--ema", "0.9", "--eval-every", "2", "--out", "run",
            "--watchdog-s", "900", "--stall-s", "77"]
    spy = Spy(monkeypatch, m, "overfit_siam")
    code, lines = run_main("siam_overfit", argv + ["--iterations", "3"])
    progress = [ln for ln in lines if re.match(r"iter \d+ loss ", ln)]
    assert code == 0 and progress and lines[-1].startswith("done: best first-half SNR ")
    assert armed == [("arm", 900)] + [("cancel",), ("arm", 77)] * len(progress)
    assert {"run/ema_best.pkl", "run/recon_best.wav"} <= set(files(work))
    metrics = json.loads(Path("run/metrics.json").read_text())
    assert [e["step"] for e in metrics["eval"]] == [2] and metrics["losses"][0][0] == 0
    assert spy.calls[0][2].last_step == 2

    code, lines = run_main("siam_overfit", argv + ["--iterations", "5", "--resume"])
    assert code == 0 and "resumed from step 2" in lines
    assert spy.calls[1][2].last_step == 4 and "run/ckpt_000000004.pkl" in files(work)
    assert [e["step"] for e in json.loads(Path("run/metrics.json").read_text())["eval"]] == [2, 4]

    (work / "refused").mkdir()
    monkeypatch.chdir(work / "refused")
    capsys.readouterr()
    assert run_main("siam_overfit", argv + ["--iterations", "3", "--commit-artifacts"])[0] == 1
    assert "--commit-artifacts" in capsys.readouterr().err and files(".") == []
    assert len(spy.calls) == 2


@pytest.mark.parametrize("name", ["overfit_refine_eval", "overfit_diag"])
def test_evaluation_runs_and_fails_without_a_checkpoint(name, work, monkeypatch, capfd):
    """On a seeded run at tiny widths (the scripts' widths shrunk): the
    script's files, ``mptpu``'s noise, the result of a direct call; a run
    directory without ``ckpt_*.pkl`` exits 1 with the reason (on the
    descriptor: the watchdog needs a real one)."""
    from mptpu_torch.models import overfit_diag, overfit_refine_eval

    for k, x in TINY_WIDTHS.items():
        monkeypatch.setitem(overfit_refine_eval.WIDTHS, k, x)
    module, fn = {"overfit_refine_eval": (overfit_refine_eval, "refine_eval"),
                  "overfit_diag": (overfit_diag, "diag")}[name]
    seeded_run(work / "run")
    spy = Spy(monkeypatch, module, fn)
    code, lines = run_main(name, ["--run", "run"])
    assert code == 0 and lines[0] == "loaded run/ckpt_000000007.pkl (step 7)"
    written = "refine_eval.json" if fn == "refine_eval" else "diag.json"
    assert json.loads(Path("run", written).read_text())["ckpt"] == "run/ckpt_000000007.pkl"
    np.testing.assert_array_equal(spy.calls[0][1]["noise"].numpy(), noise(4, 2**13, 42))
    assert spy.calls[0][2] == spy.direct()
    (work / "empty").mkdir()
    capfd.readouterr()
    assert run_main(name, ["--run", "empty"])[0] == 1
    assert "no ckpt_*.pkl in empty" in capfd.readouterr().err


def test_holdout_anatomy_runs(work, monkeypatch, capsys):
    """``<run>/anatomy.json`` by default, ``--out`` elsewhere, the held-out
    corpus under the working directory; no checkpoint: exit 1."""
    seeded_run(work / "run")
    code, lines = run_main("holdout_anatomy", ["--run", "run"])
    assert code == 0 and lines[0] == "checkpoint step 7" and lines[-1] == "wrote run/anatomy.json"
    summary = json.loads(Path("run/anatomy.json").read_text())
    assert summary["checkpoint_step"] == 7 and len(summary["events"]) == 4
    code, lines = run_main("holdout_anatomy", ["--run", "run", "--out", "a.json", "--align", "8"])
    assert code == 0 and lines[-1] == "wrote a.json"
    assert json.loads(Path("a.json").read_text())["align_budget"] == 8
    Path("run/ckpt_000000007.pkl").unlink()
    capsys.readouterr()
    assert run_main("holdout_anatomy", ["--run", "run"])[0] == 1
    assert "no checkpoint under run" in capsys.readouterr().err


def test_report_generalization_runs(work, capsys):
    """Runs under ``trained_weights`` in the working directory; the script's
    line for a run without ``metrics.json``; none left: exit 1."""
    Path("trained_weights/r1").mkdir(parents=True)
    Path("trained_weights/r1/metrics.json").write_text(json.dumps(
        {"eval": [{"step": s, "first_half_lsd_db": 30.0 - s} for s in range(3)],
         "losses": [[s, 1.0] for s in range(10)]}))
    code, lines = run_main("report_generalization", ["--runs", "r1:first,r2:second", "--out",
                                                     "g.html"])
    assert code == 0 and lines == ["skip r2: no metrics.json", "wrote g.html"]
    assert "first" in Path("g.html").read_text()
    capsys.readouterr()
    assert run_main("report_generalization", ["--runs", "r2"])[0] == 1
    assert "no runs with eval trajectories found" in capsys.readouterr().err


def test_multiband_parity_runs(work, monkeypatch):
    """At a small configuration: one JSON line a row, then the port's alone
    (no reference), ``trained_weights/multiband_parity.json`` under the
    working directory with the rows of a direct call, rounded as the script
    rounds."""
    from chip_smoke import SCRIPTS_SMALL
    from mptpu_torch.models import multiband_parity as m

    monkeypatch.setattr(m, "CONFIG", dict(m.CONFIG, **SCRIPTS_SMALL["multiband"]["config"]))
    code, lines = run_main("multiband_parity", ["--iterations", "2", "--steps", "8"])
    assert code == 0 and lines[0].startswith("no reference implementation (MPTPU_REFERENCE")
    assert re.fullmatch(r"ours [\d.]+ dB after 2 iterations \([\d.]+s\)", lines[-1])
    written = json.loads(Path("trained_weights/multiband_parity.json").read_text())
    assert [json.loads(ln) for ln in lines[1:-1]] == written["rows"]
    direct = m.parity_trajectory(2, device="cpu", log=lambda line: None, steps=8)
    assert [r["ours_snr_db"] for r in written["rows"]] == [
        round(r["ours_snr_db"], 3) for r in direct["rows"]]
    assert list(written["rows"][0]) == ["iteration", "ours_snr_db", "ours_learn_s"]
    assert files(work) == ["trained_weights/multiband_parity.json"]


TRAINERS = {
    "audiooperator": ["--smoke", "--iterations", "2"],
    "funcsong": ["--smoke", "--iterations", "2", "--song-seconds", "2"],
    "textural": ["--smoke", "--iterations", "2"],
    "roomsim": ["--n-frames", "16", "--overfit-steps", "2"],
    "phaseinvariance": ["--n-samples", "4096", "--iterations", "2"],
}


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_runs(name, work):
    """At ``--smoke`` or small counts: exit 0, the script's files and
    last line, finite losses."""
    code, lines = run_main(name, TRAINERS[name])
    assert code == 0
    assert re.fullmatch(r"done( in [\d.]+s)?", lines[-1]), lines[-1]
    metrics = json.loads(next(Path("trained_weights").glob("*/metrics.json")).read_text())
    losses = {"roomsim": lambda: [v for _, v in metrics["overfit_losses"]],
              "phaseinvariance": lambda: [r["final_loss"] for r in metrics.values()]}.get(
        name, lambda: [v for _, v in metrics["losses"]])()
    assert losses and np.all(np.isfinite(losses))


def test_funcsong_fits_a_wav(work):
    """``--path``: the WAV read by the port's reader, its rate kept in the
    render."""
    from mptpu_torch.data.synthetic import synthetic_audio
    from mptpu_torch.utils.wav import write_wav

    write_wav("song.wav", synthetic_audio(8192, 16000, seed=2), 16000)
    code, lines = run_main("funcsong", ["--smoke", "--iterations", "2", "--path", "song.wav"])
    assert code == 0 and lines[0].endswith("/ 8192 samples = compression ratio 0.84")
    with wave.open("trained_weights/funcsong/recon_crop.wav") as w:
        assert w.getframerate() == 16000 and w.getnframes() == 2**11
    assert json.loads(Path("trained_weights/funcsong/metrics.json").read_text())[
        "total_samples"] == 8192


def wav_ints(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.int32)


def test_roomsim_against_the_script(work, monkeypatch):
    """``roomsim --n-frames 64`` and ``scripts/roomsim.py --n-frames 64`` on
    JAX-CPU: the same files, the recording within one 16-bit step, the
    frames within 1e-6 of their peak, the same sample count."""
    import sys

    path = ROOT / "scripts" / "roomsim.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--n-frames", "64", "--out", "script"])
    runpy.run_path(str(path), run_name="__main__")
    code, _ = run_main("roomsim", ["--n-frames", "64", "--out", "port"])
    assert code == 0 and files("script") == files("port") == ["frames.npy", "metrics.json",
                                                              "recording.wav"]
    want, got = wav_ints(work / "script" / "recording.wav"), wav_ints(work / "port" /
                                                                      "recording.wav")
    assert want.shape == got.shape == (64 * 64,) and np.abs(want).max() == 32767
    assert np.abs(got - want).max() <= 1
    fw, fg = np.load("script/frames.npy"), np.load("port/frames.npy")
    assert fw.shape == fg.shape == (64, 5, 17)
    np.testing.assert_allclose(fg, fw, rtol=0, atol=1e-6 * np.abs(fw).max())
    metrics = [json.loads(Path(d, "metrics.json").read_text()) for d in ("script", "port")]
    assert metrics[0]["n_samples"] == metrics[1]["n_samples"] == 64 * 64


def test_train_siam_on_two_gloo_ranks(work):
    """``--tiny --iterations 2 --data-parallel --port 0 --device cpu`` on
    two gloo ranks, each a process as a launcher starts it, beside one
    process on the whole batch: the ranks' parameters identical bit for bit,
    their losses within 1e-3 relative of the one process's, files written by
    rank 0 alone (its dashboard and, with ``--save-weights``, its
    checkpoint)."""
    import chip_smoke
    from mptpu_torch.data import datastore

    datastore._resolve_path(None)   # the demo corpus, before the processes read it
    argv = ["--tiny", "--iterations", "2", "--data-parallel", "--port", "0", "--seed", "0",
            "--log-every", "1", "--save-weights", "--device", "cpu"]
    runs = chip_smoke.train_siam_ranks(work / "ranks", argv, 2,
                                       dict(os.environ, PYTHONPATH=str(ROOT)), threads=1,
                                       timeout=240)
    assert [r["code"] for r in runs.values()] == [0, 0, 0]
    for a, b in zip(runs[0]["params"], runs[1]["params"], strict=True):
        assert np.array_equal(a, b)
    assert runs[0]["losses"] == runs[1]["losses"] and len(runs[0]["losses"]) == 2
    np.testing.assert_allclose(runs[0]["losses"], runs["one"]["losses"], rtol=1e-3)
    assert files(work / "ranks" / "rank1") == []
    assert {"trained_weights/siam/ckpt_000000000.pkl"} <= set(files(work / "ranks" / "rank0"))
    assert any(f.startswith("trained_weights/siam_dashboard") for f in
               files(work / "ranks" / "rank0"))


def test_the_checkout_is_unchanged(checkout):
    """Every command line wrote only into its working directory."""
    assert tracked_files() == checkout
