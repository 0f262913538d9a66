"""The port's command lines (``mptpu_torch.scripts``) against the sixteen
scripts of ``README.md``'s entry points, on the CPU.

- Parsers (of those and of the eleven other scripts with one, ``A12B``):
  each script's own parser, captured by loading the script with
  ``argparse.ArgumentParser.parse_args`` patched to record the parser and
  stop, against the module's ``build_parser()``, action for action; the
  port adds ``--device`` alone.
- Runs: each ``main([... , "--device", "cpu"])`` at ``--tiny`` or the
  smallest flags, in a temporary working directory: its exit code, the
  lines it prints, the files it writes under the script's names, the call
  it makes (the function of ``mptpu_torch.models`` with the keywords the
  script's ``__main__`` passes) and that call's result against a direct call
  with those keywords. Corpus draws are seeded (``np.random.default_rng``
  without a seed takes 0) and the global torch seed is set before each
  call, so that the two runs see the same data.
- The main path against ``mptpu``: ``mp_train --tiny`` (flat and
  ``--multiband``) beside ``scripts/mp_train.py --tiny`` on JAX-CPU fed the
  same batches and starting dictionaries (as ``tests/test_torch_mp_train.py``
  does), SNRs within its 0.05 dB and the stored bands within its 1e-5;
  ``codec_rate --run`` beside ``scripts/codec_rate.py --run`` on the seeded
  checkpoint of ``tests/test_torch_codec_rate.py`` with ``mptpu``'s noise,
  counts equal, SNRs within its 0.01 dB.
- Every successful run leaves the files of ``chip_smoke.cli_required``,
  the table phase 16 holds the card's runs to.
- ``experiment --list`` and ``experiment`` started from the checkout's root
  load neither ``jax`` nor ``mptpu`` (the checkout's ``experiments/`` is
  ``mptpu``'s); the checkout's tracked files are unchanged at the end,
  against a snapshot taken before the module's first test.
"""

import argparse
import contextlib
import faulthandler
import io
import json
import os
import re
import runpy
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from mptpu_torch import convert
from mptpu_torch.models import siam as ts
from mptpu_torch.utils import jax_random

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("mp_train", "codec_rate", "overfit_stream_eval", "train_siam", "siam_quality",
           "build_index", "splat", "ssm_article", "songsplat", "instrument",
           "resonance_overfit", "energy_overfit", "texture", "report", "worker", "experiment")
# the eleven remaining scripts with a parser (ROADMAP A12b); their runs are
# tests/test_torch_scripts_cli_more.py's
A12B = ("siam_overfit", "overfit_refine_eval", "overfit_diag", "holdout_anatomy",
        "report_generalization", "multiband_parity", "audiooperator", "funcsong", "textural",
        "roomsim", "phaseinvariance")
ATTRS = ("option_strings", "dest", "default", "type", "choices", "nargs", "const", "required",
         "help", "metavar")
# the seeded tiny SIAM checkpoint of tests/test_torch_codec_rate.py
N, E = 2**13, 4
CFG = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=E,
           transform_window_size=512, transform_step_size=256, fft_resonance=True,
           attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0, switch_clamp=20.0,
           residual_clamp_scale=4.0, encoder_clamp=1e4)
CONFIG = ("overfit 1 segment seed 3, n_samples 2^13, 4 events, STFT 512/256, lr 0.0003, "
          "audio_events 4, stream_windows 2, spectral_skip False, spectral_filter False")
WALK_CONFIG = ("overfit n_samples 2^13, 4 events, STFT 2048/256, spectral_skip False, "
               "spectral_filter False")
RUN_FLAGS = ["--n-samples-log2", "13", "--n-events", "4", "--hidden", "32",
             "--context-dim", "16"]


def tracked_files():
    """{path: git's hash of its content, or None where it is absent} of
    every file git tracks in the checkout."""
    out = subprocess.run(["git", "ls-files", "-z"], cwd=str(ROOT), capture_output=True,
                         check=True).stdout.decode()
    paths = [rel for rel in out.split("\0") if rel]
    present = [rel for rel in paths if (ROOT / rel).is_file()]
    hashes = subprocess.run(["git", "hash-object", "--stdin-paths"], cwd=str(ROOT),
                            input="\n".join(present), capture_output=True, text=True,
                            check=True).stdout.split()
    return dict({rel: None for rel in paths}, **dict(zip(present, hashes, strict=True)))


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
    """A working directory of its own, the module's corpus, seeded corpus
    draws, and no watchdog left armed afterwards."""
    monkeypatch.setenv("MPTPU_CACHE", str(cache))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    draw = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: draw(0 if seed is None
                                                                         else seed))
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory: the port's seeded tiny SIAM parameters as
    ``ema_best.pkl`` (mptpu's checkpoint format) and a config line that
    records a two-window segment."""
    from mptpu.train.checkpoint import save_checkpoint

    run = tmp_path_factory.mktemp("run")
    model = ts.SIAMModel(**CFG, generator=torch.Generator().manual_seed(1), device="cpu")
    save_checkpoint(str(run / "ema_best.pkl"), convert.module_to_flax(model), None, 7)
    (run / "metrics.json").write_text(json.dumps({"config": CONFIG, "eval": []}))
    return run


@pytest.fixture(scope="module")
def walk_run_dir(tmp_path_factory):
    """A run directory for the streaming walk, whose script builds its model
    at STFT 2048/256: seeded tiny parameters at that window as
    ``ckpt_000000007.pkl``."""
    from mptpu.train.checkpoint import save_checkpoint

    run = tmp_path_factory.mktemp("walk_run")
    model = ts.SIAMModel(**dict(CFG, in_channels=1025, transform_window_size=2048),
                         generator=torch.Generator().manual_seed(1), device="cpu")
    save_checkpoint(str(run / "ckpt_000000007.pkl"), convert.module_to_flax(model), None, 7)
    (run / "metrics.json").write_text(json.dumps({"config": WALK_CONFIG, "eval": []}))
    return run


def script_parser(name):
    """``scripts/<name>.py``'s parser, captured where it is parsed."""
    captured = {}

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise Parsed

    path = ROOT / "scripts" / f"{name}.py"
    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture), \
            mock.patch.object(sys, "argv", [str(path)]), contextlib.suppress(Parsed):
        runpy.run_path(str(path), run_name="__main__")
    return captured["parser"]


def port_module(name):
    import importlib

    return importlib.import_module(f"mptpu_torch.scripts.{name}")


@pytest.mark.parametrize("name", SCRIPTS + A12B)
def test_parser_is_the_scripts(name):
    want = {a.dest: a for a in script_parser(name)._actions}
    got = {a.dest: a for a in port_module(name).build_parser()._actions}
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    for dest, w in want.items():
        g = got[dest]
        assert type(g) is type(w), dest
        for attr in ATTRS:
            assert getattr(g, attr) == getattr(w, attr), (dest, attr)
    assert got["device"].default == "cuda" and got["device"].option_strings == ["--device"]


class Spy:
    """Records each call of ``module.fn`` (args, kwargs, result) and lets it
    through."""

    def __init__(self, monkeypatch, module, fn):
        self.calls = []
        self.fn = getattr(module, fn)

        def spy(*args, **kwargs):
            result = self.fn(*args, **kwargs)
            self.calls.append((args, kwargs, result))
            return result

        monkeypatch.setattr(module, fn, spy)

    def direct(self):
        """The first recorded call made again, directly, after the same
        seeding."""
        args, kwargs, _ = self.calls[0]
        torch.manual_seed(0)
        return self.fn(*args, **kwargs)


def run_main(name, argv, stdin=None):
    """(exit code, printed lines) of the port's ``main(argv + cpu)``; a run
    that exits 0 has left ``chip_smoke.cli_required``'s files."""
    import chip_smoke

    buf = io.StringIO()
    torch.manual_seed(0)
    with contextlib.redirect_stdout(buf), \
            mock.patch.object(sys, "stdin", io.StringIO(stdin or "")):
        code = port_module(name).main(list(argv) + ["--device", "cpu"])
    if code == 0:
        missing = chip_smoke.cli_required(name, argv) - set(files("."))
        assert not missing, (name, argv, missing)
    return code, buf.getvalue().splitlines()


def files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def state_equal(m1, m2):
    for x, y in zip(m1.state_dict().values(), m2.state_dict().values(), strict=True):
        assert torch.equal(x, y)


def tiny_batches(n_samples, k):
    from mptpu_torch.data import synthetic_audio

    return [np.stack([synthetic_audio(n_samples, seed=100 + 2 * j + i)[None] for i in range(2)])
            for j in range(k)]


def case_mp_train(work, monkeypatch, run_dir):
    from mptpu_torch.models import mp_train as m

    batches = tiny_batches(4096, 5)
    monkeypatch.setattr(m, "AudioIterator", lambda *a, **k: [torch.from_numpy(b)
                                                             for b in batches])
    flat = Spy(monkeypatch, m, "train_flat")
    code, lines = run_main("mp_train", ["--tiny"])
    assert code == 0
    assert lines[0].startswith("initial recon SNR @ 16 atoms: ")
    assert [re.match(r"sweep (\d+): recon SNR", ln).group(1) for ln in lines[1:]] == ["0", "3"]
    args, kwargs, r = flat.calls[0]
    assert args == () and kwargs == dict(n_atoms=64, atom_size=128, n_samples=4096, n_steps=16,
                                         sweeps=4, batch_size=2, audio_path=None, device="cpu")
    again = flat.direct()
    assert torch.equal(r.learned, again.learned) and r.initial_snr_db == again.initial_snr_db
    assert [s for _, s, _ in r.reports] == [s for _, s, _ in again.reports]
    assert files(work) == []

    multi = Spy(monkeypatch, m, "train_multiband")
    code, lines = run_main("mp_train", ["--tiny", "--multiband"])
    assert code == 0 and lines[0].startswith("initial multiband SNR: ")
    assert re.fullmatch(r"sweep 3: SNR -?[\d.]+ dB, 128 events over 256 global atoms", lines[-1])
    assert files(work) == [f"trained_weights/band_{s}.dat" for s in (1024, 2048, 4096, 512)]
    args, kwargs, r = multi.calls[0]
    assert args == ("trained_weights",) and kwargs == flat.calls[0][1]
    (work / "direct").mkdir()
    monkeypatch.chdir(work / "direct")
    again = multi.direct()
    for size, band in r.learned.bands.items():
        assert torch.equal(band.d, again.learned.bands[size].d)


def case_codec_rate(work, monkeypatch, run_dir):
    from mptpu_torch.models import codec_rate as m

    run = str(shutil.copytree(run_dir["rate"], work / "run"))
    spy = Spy(monkeypatch, m, "rate_report")
    code, lines = run_main("codec_rate", ["--run", run, "--refine", "64"] + RUN_FLAGS)
    assert code == 0
    assert lines[:3] == [f"[config] --audio-events <- 4 (from {run}/metrics.json)",
                         f"[config] --stream-windows <- 2 (from {run}/metrics.json)",
                         f"loaded {run}/ema_best.pkl (step 7)"]
    assert json.loads("\n".join(lines[3:])) == json.loads(Path(run, "codec_rate.json").read_text())
    assert files(work) == ["run/codec_rate.json", "run/ema_best.pkl", "run/metrics.json",
                           "run/recon_wire_f16.wav"]
    args, kwargs, r = spy.calls[0]
    # mptpu's noise, for the run's 4 events
    np.testing.assert_array_equal(kwargs.pop("noise").numpy(), jax_random.siam_event_noise(4, N))
    assert args == (run, run) and kwargs == dict(
        ckpt=None, walk=False, device="cpu", selection_leak=0.02, selection_floor=0.02,
        attn_floor=0.01, attn_leak=0.1, switch_clamp=20.0, seed=3, n_samples_log2=13,
        n_events=4, hidden=32, context_dim=16, audio_events=0, stream_windows=1, refine=64)
    kwargs["noise"] = torch.from_numpy(jax_random.siam_event_noise(4, N))
    assert r == m.rate_report(*args, **kwargs, log=lambda line: None)
    assert run_main("codec_rate", ["--run", str(work)])[0] == 1   # no checkpoint there


def case_overfit_stream_eval(work, monkeypatch, run_dir):
    from mptpu_torch.models import overfit_stream_eval as m

    run = str(shutil.copytree(run_dir["walk"], work / "run"))
    spy = Spy(monkeypatch, m, "stream_eval")
    code, lines = run_main("overfit_stream_eval", ["--run", run, "--stream-windows", "2"]
                           + RUN_FLAGS)
    assert code == 0 and lines[0] == f"loaded {run}/ckpt_000000007.pkl (step 7)"
    written = json.loads(Path(run, "stream_eval.json").read_text())
    assert json.loads("\n".join(lines[1:])) == written and written["stream_windows"] == 2
    assert files(work) == ["run/ckpt_000000007.pkl", "run/metrics.json",
                           "run/recon_streaming.wav", "run/stream_eval.json"]
    args, kwargs, r = spy.calls[0]
    assert args == (run, run) and kwargs["ckpt"] is None and kwargs["stream_windows"] == 2
    assert set(kwargs) == set(m.DEFAULTS) | {"ckpt", "noise", "device"}
    np.testing.assert_array_equal(kwargs["noise"].numpy(), jax_random.siam_event_noise(4, N))
    assert r == spy.direct()


def case_train_siam(work, monkeypatch, run_dir):
    from mptpu_torch.models import siam_train as m

    spy = Spy(monkeypatch, m, "train_and_monitor")
    code, lines = run_main("train_siam", ["--tiny", "--iterations", "1", "--port", "0",
                                          "--seed", "0", "--save-weights", "--data-parallel"])
    assert code == 0 and re.fullmatch(r"iter 0 loss -?[\d.]+ \([\d.]+s\)", lines[0])
    args, kwargs, r = spy.calls[0]
    # one process: the whole batch, as the script on one device (it joins no process group)
    assert kwargs["data_parallel"] is False and kwargs["port"] == 0 and kwargs["seed"] == 0
    assert kwargs["tiny"] is True and kwargs["iterations"] == 1 and kwargs["device"] == "cpu"
    (work / "direct").mkdir()
    monkeypatch.chdir(work / "direct")
    again = spy.direct()
    assert r.losses == again.losses
    state_equal(r.model, again.model)


def case_siam_quality(work, monkeypatch, run_dir):
    from mptpu_torch.models import siam_quality as m

    spy = Spy(monkeypatch, m, "run_siam_quality")
    code, lines = run_main("siam_quality", ["--tiny", "--iterations", "3", "--timing-steps", "0",
                                            "--out", "q"])
    assert code == 0 and lines[-1] == "done"
    assert files(work) == ["q/ckpt_000000002.pkl", "q/metrics.json"]
    args, kwargs, r = spy.calls[0]
    assert args == ("q",) and kwargs["device"] == "cpu" and kwargs["watchdog_s"] == 14000
    assert set(kwargs) - {"device", "log"} == {
        a.dest for a in port_module("siam_quality").build_parser()._actions} - {
        "help", "out", "stall_s", "device"}
    kwargs["log"] = lambda line: None
    again = m.run_siam_quality(os.path.join("direct", "q"), *args[1:], **kwargs)
    assert r.step_losses == again.step_losses


def case_build_index(work, monkeypatch, run_dir):
    from mptpu_torch.models import search as m

    spy = Spy(monkeypatch, m, "index_corpus")
    code, lines = run_main("build_index", ["--chunks", "2", "--chunk-size", "2048"])
    assert code == 0 and lines[0] == "indexed 2 chunks" and lines[1].startswith("query: ")
    assert len(lines) == 4 and all(ln.startswith("  -> ") for ln in lines[2:])
    args, kwargs, r = spy.calls[0]
    assert args == (2, 2048, None, True) and kwargs == dict(device="cpu")
    again = spy.direct()
    assert r.keys == again.keys and torch.equal(r.embeddings, again.embeddings)
    assert r.result_keys == again.result_keys


def case_splat(work, monkeypatch, run_dir):
    from mptpu_torch.models import splat_overfit as m

    fit, article = Spy(monkeypatch, m, "overfit_splat"), Spy(monkeypatch, m, "splat_article")
    code, lines = run_main("splat", ["--n-samples", "4096", "--n-events", "4", "--iterations",
                                     "2", "--article", "splat.html"])
    assert code == 0 and re.fullmatch(r"iter 0 loss -?[\d.]+", lines[0])
    assert re.fullmatch(r"[\d.]+ overfit steps/sec", lines[1])
    assert lines[2] == "article written to splat.html" and files(work) == ["splat.html"]
    args, kwargs, r = fit.calls[0]
    assert args[0].shape == (1, 1, 4096) and kwargs == dict(
        n_events=4, n_iterations=2, use_iterative_loss=False, device="cpu")
    assert article.calls[0][0] == (r, args[0], "splat.html")
    again = fit.direct()
    assert r.losses == again.losses
    state_equal(r.model, again.model)


def case_ssm_article(work, monkeypatch, run_dir):
    from mptpu_torch.models import ssm_overfit as m

    spy = Spy(monkeypatch, m, "train_model_for_segment")
    code, lines = run_main("ssm_article", ["--tiny", "--iterations", "2", "--article",
                                           "ssm.html"])
    assert code == 0 and re.fullmatch(r"iter 0 loss -?[\d.]+", lines[0])
    assert lines[-1] == "article -> ssm.html; weights -> ssm_weights.json"
    assert files(work) == ["ssm.html", "ssm_weights.json"]
    args, kwargs, r = spy.calls[0]
    assert kwargs == dict(n_iterations=2, article_path="ssm.html", audio_path=None,
                          n_samples=2**13, window_size=64, control_plane_dim=16, state_dim=32,
                          n_active_sites=64, device="cpu")
    (work / "direct").mkdir()
    monkeypatch.chdir(work / "direct")
    again = spy.direct()
    assert r.losses == again.losses and torch.equal(r.target, again.target)


def case_songsplat(work, monkeypatch, run_dir):
    from mptpu_torch.models import songsplat as m

    spy = Spy(monkeypatch, m, "train_songsplat")
    code, lines = run_main("songsplat", ["--tiny", "--iterations", "2", "--log-every", "1"])
    assert code == 0 and lines[0].startswith("song 32768 samples, ")
    assert lines[-1].startswith("song eval ")
    args, kwargs, r = spy.calls[0]
    assert kwargs == dict(iterations=2, tiny=True, song=None, port=0,
                          out="trained_weights/songsplat", log_every=1, sparsity=0.0, refit=0.0,
                          resume=False, render_only=False, device="cpu")
    kwargs["out"] = "direct"
    again = m.train_songsplat(**kwargs, log=lambda line: None)
    assert r.step_losses == again.step_losses and r.eval == again.eval
    # --render-only implies --resume and renders from the run's newest checkpoint
    code, lines = run_main("songsplat", ["--tiny", "--render-only"])
    assert code == 0 and spy.calls[-1][1]["resume"] and spy.calls[-1][1]["render_only"]


def case_instrument(work, monkeypatch, run_dir):
    from mptpu_torch.models import instrument as m

    build, demo = Spy(monkeypatch, m, "build_instrument"), Spy(monkeypatch, m, "demo_phrase")
    code, lines = run_main("instrument", ["--tiny", "--demo", "out.wav"])
    assert code == 0 and lines[-1].startswith("wrote out.wav (")
    assert files(work) == ["out.wav"]
    args, kwargs, _ = build.calls[0]
    assert args == ("trained_weights/siam", True) and kwargs == dict(
        noise_seed=0, size_overrides=None, selection_leak=0.0, selection_floor=0.0,
        device="cpu")
    assert demo.calls[0][1] == dict(harvest_seed=None, harvest_wav=None)
    again = demo.fn(build.direct(), "again.wav", log=lambda line: None)
    np.testing.assert_array_equal(demo.calls[0][2], again)
    # the REPL reads stdin
    code, lines = run_main("instrument", ["--tiny"], stdin="note 0.1\nlist\nrender r.wav\nquit\n")
    assert code == 0 and len(lines) == 4 and lines[3].startswith("wrote r.wav (")
    assert lines[1:3] == ["queued note @0.1s amp 1.0 (seed 0)", "0: t=0.1s amp=1.0"]
    assert "r.wav" in files(work)


def case_resonance_overfit(work, monkeypatch, run_dir):
    from mptpu_torch.models import resonance_overfit as m

    spy = Spy(monkeypatch, m, "overfit_resonance")
    code, lines = run_main("resonance_overfit", ["--tiny", "--iterations", "2"])
    assert code == 0 and re.fullmatch(r"iter 0 loss -?[\d.]+", lines[0])
    assert lines[-1].startswith("done: 2 iters in ") and files(work) == []
    args, kwargs, r = spy.calls[0]
    assert args == (2, True) and kwargs == dict(device="cpu")
    again = spy.direct()
    assert r.losses == again.losses


def case_energy_overfit(work, monkeypatch, run_dir):
    from mptpu_torch.models import energy_overfit as m

    spy = Spy(monkeypatch, m, "overfit_energy")
    code, lines = run_main("energy_overfit", ["--tiny", "--iterations", "2"])
    assert code == 0 and re.fullmatch(r"iter 0 loss -?[\d.]+ \(spec [\d.]+ disc [\d.]+\)",
                                      lines[0])
    assert lines[-1].startswith("done: 2 iters in ") and files(work) == []
    args, kwargs, r = spy.calls[0]
    assert args == (2, True, 0.1) and kwargs == dict(device="cpu")
    again = spy.direct()
    assert r.losses == again.losses


def case_texture(work, monkeypatch, run_dir):
    from mptpu_torch.models import texture as m

    spy = Spy(monkeypatch, m, "synthesize_texture")
    code, lines = run_main("texture", ["--tiny", "--iterations", "2", "--log-every", "1"])
    assert code == 0 and lines[0].startswith("iter 0 loss") and lines[1].startswith("iter 1 loss")
    args, kwargs, r = spy.calls[0]
    assert args == (2, 1e-3, True, "texture", "trained_weights/texture", 1)
    assert kwargs == dict(device="cpu")
    again = m.synthesize_texture(*args[:4], None, 1, device="cpu", log=lambda line: None)
    assert r.losses == again.losses and torch.equal(r.params, again.params)


def case_report(work, monkeypatch, run_dir):
    from mptpu_torch.models import report as m

    spy = Spy(monkeypatch, m, "make_report")
    code, lines = run_main("report", ["--tiny", "--out", "page.html"])
    assert code == 0 and lines[-1] == "report -> page.html" and files(work) == ["page.html"]
    args, kwargs, _ = spy.calls[0]
    assert args == ("trained_weights/siam", "page.html") and kwargs == dict(
        tiny=True, streaming=False, audio_path=None, seed=None, metrics_path=None, device="cpu")
    spy.fn(args[0], "again.html", **kwargs, log=lambda line: None)
    assert Path("page.html").read_bytes() == Path("again.html").read_bytes()
    # --overfit-run renders a run's own artifacts, no model forward
    from mptpu_torch.utils.wav import write_wav

    run = work / "overfit_run"
    run.mkdir()
    for wav in ("target.wav", "recon_best.wav"):
        write_wav(str(run / wav), np.zeros(2048, np.float32), 22050)
    (run / "metrics.json").write_text(json.dumps({"eval": [], "config": CONFIG}))
    code, lines = run_main("report", ["--overfit-run", str(run), "--out", "o.html"])
    assert code == 0 and lines[-1] == "overfit report -> o.html" and Path("o.html").exists()


def case_worker(work, monkeypatch, run_dir):
    from chip_smoke import CLI_PRESET
    from mptpu_torch.models import worker as m

    for box in ("worker_inbox", "again_inbox"):
        (work / box).mkdir()
        (work / box / "p00_ssm.json").write_text(json.dumps(CLI_PRESET))
    spy = Spy(monkeypatch, m, "run_worker")
    code, lines = run_main("worker", ["--once"])
    assert code == 0 and lines[0].startswith("embedded p00_ssm -> worker_outbox/p00_ssm.json")
    assert not (work / "worker_inbox" / "p00_ssm.json").exists()
    args, kwargs, r = spy.calls[0]
    assert args == ("worker_inbox", "worker_outbox") and kwargs == dict(
        once=True, tiny=True, checkpoint_dir=None, device="cpu")
    torch.manual_seed(0)
    again = spy.fn("again_inbox", "again_outbox", **kwargs, log=lambda line: None)
    assert r == again


def case_experiment(work, monkeypatch, run_dir):
    from datetime import datetime

    from mptpu_torch.models import experiment as m

    code, lines = run_main("experiment", ["--new"])
    now = datetime.now()
    name = f"e_{now.year}_{now.month}_{now.day}"
    assert code == 0 and lines == [f"scaffolded experiments_torch/{name}"]
    assert files(work) == ["experiments_torch/__init__.py", f"experiments_torch/{name}/__init__.py",
                           f"experiments_torch/{name}/experiment.py",
                           f"experiments_torch/{name}/readme.md"]
    assert run_main("experiment", ["--list"]) == (0, [name])
    spy = Spy(monkeypatch, m, "run_current")
    code, lines = run_main("experiment", ["--iterations", "1"])
    assert code == 0 and re.fullmatch(r"iter 0 loss -?[\d.]+", lines[0])
    args, kwargs, (r, _) = spy.calls[0]
    assert args == ("experiments_torch", 1) and kwargs == dict(device="cpu")
    again, _ = spy.direct()
    state_equal(r, again)
    # a second working directory in the same process runs its own experiment, the first one's
    # gone (the import system caches a finder for each search path it is given)
    shutil.rmtree(work / "experiments_torch")
    (work / "second").mkdir()
    monkeypatch.chdir(work / "second")
    assert run_main("experiment", ["--new"])[0] == 0
    assert run_main("experiment", ["--iterations", "1"])[0] == 0


CASES = {name: globals()[f"case_{name}"] for name in SCRIPTS}


@pytest.mark.parametrize("name", SCRIPTS)
def test_command_line_runs(name, work, monkeypatch, run_dir, walk_run_dir):
    """``main`` at ``--tiny`` or the smallest flags on the CPU: exit code,
    printed lines, files written, the call it makes and that call's result
    against a direct one."""
    CASES[name](work, monkeypatch, dict(rate=run_dir, walk=walk_run_dir))


SNR_LINE = re.compile(r"(initial|sweep \d+).*?(-?\d+\.\d+) dB")


def snrs(lines):
    """{"initial" or "sweep i": SNR} of a trainer's printed lines."""
    return {m.group(1): float(m.group(2)) for m in map(SNR_LINE.match, lines) if m}


def script_main(name, argv):
    """The printed lines of ``scripts/<name>.py argv`` run in this process."""
    path = ROOT / "scripts" / f"{name}.py"
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", [str(path)] + argv), contextlib.redirect_stdout(buf):
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("multiband", [False, True], ids=["flat", "multiband"])
def test_mp_train_tiny_against_the_script(multiband, work, monkeypatch):
    """``mp_train --tiny [--multiband]`` and ``scripts/mp_train.py`` on
    JAX-CPU, both fed the same five batches, from ``mptpu``'s starting
    dictionaries: every printed SNR within 0.05 dB of the script's and,
    with ``--multiband``, every stored band within 1e-5."""
    import jax
    import jax.numpy as jnp
    import mptpu.data
    from mptpu import sparse as jsp
    from mptpu_torch import sparse as tsp
    from mptpu_torch.convert import band_dicts_from_jax
    from mptpu_torch.models import mp_train as m

    argv = ["--tiny"] + (["--multiband"] if multiband else [])
    batches = tiny_batches(4096, 5)
    monkeypatch.setattr(mptpu.data, "AudioIterator",
                        lambda *a, **k: [jnp.asarray(b) for b in batches])
    (work / "script").mkdir()
    monkeypatch.chdir(work / "script")
    want = snrs(script_main("mp_train", argv))

    monkeypatch.setattr(m, "AudioIterator", lambda *a, **k: [torch.from_numpy(b)
                                                             for b in batches])
    d0 = np.array(jax.random.uniform(jax.random.PRNGKey(0), (64, 128), minval=-1, maxval=1))
    monkeypatch.setattr(m, "initial_dictionary",
                        lambda *a, device=None, **k: torch.from_numpy(d0).to(device))
    sizes = [s for s in m.BAND_SIZES if s <= 4096]
    dicts = band_dicts_from_jax(jsp.MultibandDictionaryLearning(
        [jsp.BandSpec(s, n_atoms=64, atom_size=128, signal_samples=4096,
                      is_lowest_band=(s == 512)) for s in sizes], 4096), device="cpu")
    build = m.multiband_model

    def from_mptpus(*args, **kwargs):
        model = build(*args, **kwargs)
        for size, band in model.bands.items():
            band.d = dicts[size]
        return model

    monkeypatch.setattr(m, "multiband_model", from_mptpus)
    (work / "port").mkdir()
    monkeypatch.chdir(work / "port")
    code, lines = run_main("mp_train", argv)
    got = snrs(lines)
    assert code == 0 and sorted(got) == sorted(want) == ["initial", "sweep 0", "sweep 3"]
    for k, w in want.items():
        assert abs(got[k] - w) <= 0.05, (k, got[k], w)
    if multiband:
        for size in sizes:
            stored = [tsp.MultibandDictionaryLearning(
                [tsp.BandSpec(s, 64, 128, signal_samples=4096, device="cpu") for s in sizes], 4096)
                for _ in range(2)]
            stored[0].load(str(work / "script" / "trained_weights"))
            stored[1].load(str(work / "port" / "trained_weights"))
            assert np.abs(stored[0].bands[size].d.numpy()
                          - stored[1].bands[size].d.numpy()).max() <= 1e-5


def test_codec_rate_against_the_script(work, monkeypatch, run_dir):
    """``codec_rate --run`` and ``scripts/codec_rate.py --run`` on JAX-CPU,
    each on its own copy of the seeded run (both decode with ``mptpu``'s
    noise): the same files, counts and bytes equal, every SNR within 0.01 dB
    of the script's."""
    from mptpu_torch.models import codec_rate as m

    argv = ["--refine", "64", "--watchdog-s", "600"] + RUN_FLAGS
    want_run = shutil.copytree(run_dir, work / "script")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "codec_rate.py"), "--run",
                           str(want_run)] + argv, cwd=str(ROOT), capture_output=True, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    want = json.loads((want_run / "codec_rate.json").read_text())
    spy = Spy(monkeypatch, m, "rate_report")
    got_run = shutil.copytree(run_dir, work / "port")
    code, _ = run_main("codec_rate", ["--run", str(got_run)] + argv)
    assert code == 0 and files(got_run) == files(want_run)
    got, written = spy.calls[0][2], json.loads((got_run / "codec_rate.json").read_text())
    checked = 0
    for preset, row in want["presets"].items():
        for k, w in row.items():
            if k.endswith("_db"):
                assert abs(got["presets"][preset][k] - w) <= 0.01, (preset, k, w)
            else:
                assert written["presets"][preset][k] == w, (preset, k, w)
            checked += 1
    assert abs(got["raw_first_half_snr_db"] - want["raw_first_half_snr_db"]) <= 0.01
    assert checked >= 12


def test_experiment_at_the_checkouts_root():
    """``experiment --list`` and ``experiment`` started as ``python -m``
    from the checkout's root, whose ``experiments/`` holds ``mptpu``'s
    experiments: the list is empty, the run exits 1 for want of the port's
    own, and neither ``jax`` nor ``mptpu`` (nor their optimiser and layers)
    is loaded."""
    code = (
        "import json, runpy, sys\n"
        "codes = []\n"
        "for argv in (['--list'], []):\n"
        "    sys.argv = ['experiment'] + argv + ['--device', 'cpu']\n"
        "    try:\n"
        "        runpy.run_module('mptpu_torch.scripts.experiment', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        codes.append(e.code)\n"
        "loaded = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'mptpu', 'optax', "
        "'flax'})\n"
        "print(json.dumps(dict(codes=codes, loaded=loaded)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "" and json.loads(lines[-1]) == dict(codes=[0, 1], loaded=[])
    assert "no current experiment: experiments_torch/__init__.py is absent" in proc.stderr


def test_the_checkout_is_unchanged(checkout):
    """Every command line wrote only into its working directory, and none
    run from the checkout's root wrote there."""
    assert tracked_files() == checkout
