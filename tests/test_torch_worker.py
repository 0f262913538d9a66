"""The synth-preset worker of the port (``mptpu_torch.models.worker``)
against ``scripts/worker.py`` on JAX-CPU, loaded with ``importlib``: both
run once (``once=True``) over an inbox of the same presets at ``--tiny``'s
widths (2^12 samples, 2 events, context 8, hidden 16, STFT 512/256), from
one seeded checkpoint (the port's parameters written by ``mptpu``'s
``save_checkpoint`` under ``CheckpointManager``'s naming).

The script's draws are carried across: the projection
``normal(PRNGKey(0), (16, 128)) / 4``, the decoder's noise (event ``i``
from ``fold_in(PRNGKey(0), i)``) and its noise synth's render
``normal(PRNGKey(0), (1, 1, n)) * 0.1`` (the port's ``render`` hook feeds
it; the port's own draws come from a torch generator). An ``ssm`` preset's
synth is seeded by the id's CRC-32 in the port (the script's ``hash`` of
the id changes between processes), so the script's synth is handed the
port's parameters for it.

Tolerances: the rendered audio within 1e-5 of its largest; each embedding
within 1e-4 of its largest; the chunks' ids and order identical.
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

from mptpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mptpu_torch import convert
from mptpu_torch.models import worker as wk

ROOT = Path(__file__).resolve().parent.parent
N = 2**12
PRESETS = [
    {"preset_id": "a_ssm", "synth": "ssm",
     "params": {"control_plane_dim": 8, "window_size": 64, "state_dim": 16}},
    {"preset_id": "b_noise", "synth": "noise", "params": {}},
    {"preset_id": "c_ssm", "synth": "ssm", "params": {"control_plane_dim": 4, "state_dim": 8}},
]


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def write_inbox(path):
    path.mkdir()
    for p in PRESETS:
        (path / f"{p['preset_id']}.json").write_text(json.dumps(p))


def port_synth(preset):
    """The port's ``ssm`` synth for ``preset`` as render_preset builds it."""
    p = preset["params"]
    return wk.OverfitControlPlane(
        control_plane_dim=int(p.get("control_plane_dim", 16)),
        input_dim=int(p.get("window_size", 64)), state_matrix_dim=int(p.get("state_dim", 32)),
        n_samples=N, window_size=int(p.get("window_size", 64)),
        init_generator=torch.Generator().manual_seed(wk.preset_seed(preset["preset_id"])),
        device="cpu")


def flax_variables(model):
    """The port's ``OverfitControlPlane`` as ``mptpu``'s flax variables."""
    ssm = model.ssm
    return {"params": {"control": model.control.detach().numpy(),
                       "ssm": {"proj": ssm.proj.detach().numpy(),
                               "w_ih": ssm.rnn.weight_ih_l0.detach().numpy().T,
                               "w_hh": ssm.rnn.weight_hh_l0.detach().numpy().T,
                               "out_proj": ssm.out_proj.detach().numpy()}}}


@pytest.fixture(scope="module")
def worked(tmp_path_factory):
    """(the script's chunks, the port's chunks and outbox, the script's
    renders by preset id)."""
    root = tmp_path_factory.mktemp("worker")
    ckpts = root / "ckpt"
    ckpts.mkdir()
    model = wk.worker_model(tiny=True, device="cpu")
    j_save_checkpoint(str(ckpts / "ckpt_000000003.pkl"), convert.module_to_flax(model), None, 3)

    spec = importlib.util.spec_from_file_location("worker_script", ROOT / "scripts" / "worker.py")
    script = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = script   # its dataclasses look their module up
    spec.loader.exec_module(script)
    renders = {}
    real = script.OverfitControlPlane
    current = {}

    class Synth:
        """The script's synth, its parameters the port's for the preset."""

        def __init__(self, **kw):
            self.model = real(**kw)

        def init(self, key):
            return flax_variables(port_synth(current["preset"]))

        def apply(self, params):
            return self.model.apply(params)

    script.OverfitControlPlane = Synth
    real_render = script.render_preset

    def render(preset, n, key):
        current["preset"] = {"preset_id": preset.preset_id, "params": preset.params}
        audio = real_render(preset, n, key)
        renders[preset.preset_id] = np.asarray(audio)
        return audio

    script.render_preset = render
    write_inbox(root / "script_in")
    script.run_worker(str(root / "script_in"), str(root / "script_out"), once=True, tiny=True,
                      checkpoint_dir=str(ckpts))
    want = {f[:-5]: json.loads((root / "script_out" / f).read_text())
            for f in sorted(os.listdir(root / "script_out"))}

    key = jax.random.PRNGKey(0)
    proj = np.asarray(jax.random.normal(key, (16, 128))) / np.float32(np.sqrt(16))
    noise = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (1, 1, N),
                                                    minval=-1.0, maxval=1.0)) for i in range(2)])
    noise_render = np.asarray(jax.random.normal(key, (1, 1, N))) * 0.1

    def port_render(preset, n):
        if preset.synth == "ssm":
            return wk.render_preset(preset, n, device="cpu")
        return torch.from_numpy(noise_render)

    write_inbox(root / "port_in")
    got = wk.run_worker(str(root / "port_in"), str(root / "port_out"), once=True, tiny=True,
                        checkpoint_dir=str(ckpts), proj=torch.from_numpy(proj),
                        noise=torch.from_numpy(noise), render=port_render, device="cpu",
                        log=lambda s: None)
    return want, got, root, renders


def test_embeddings_match_the_script(worked):
    want, got, root, _ = worked
    assert [c.preset_id for c in got] == sorted(want) == [p["preset_id"] for p in PRESETS]
    for chunk in got:
        w = np.asarray(want[chunk.preset_id]["embedding"])
        g = np.asarray(chunk.embedding)
        assert g.shape == w.shape == (128,)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), chunk.preset_id
        written = json.loads((root / "port_out" / f"{chunk.preset_id}.json").read_text())
        assert written == {"preset_id": chunk.preset_id, "embedding": chunk.embedding}
    assert os.listdir(root / "port_in") == [] and os.listdir(root / "script_in") == []


def test_ssm_render_matches_the_script(worked):
    """render_preset of an ``ssm`` preset against the script's synth with
    the same parameters."""
    _, _, _, renders = worked
    for p in PRESETS:
        if p["synth"] != "ssm":
            continue
        got = wk.render_preset(wk.SynthPreset(**p), N, device="cpu").numpy()
        want = renders[p["preset_id"]]
        assert got.shape == want.shape == (1, 1, N)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_noise_render_and_seeds_are_deterministic():
    noise = wk.SynthPreset("x", "other", {})
    a = wk.render_preset(noise, 1024, device="cpu")
    b = wk.render_preset(noise, 1024, device="cpu")
    assert torch.equal(a, b) and a.shape == (1, 1, 1024)
    assert 0.05 < float(a.std()) < 0.2
    assert wk.preset_seed("a_ssm") == wk.preset_seed("a_ssm") != wk.preset_seed("c_ssm")


def test_transports_plug_in():
    """An inbox and outbox of the caller's: presets taken in order, each
    acknowledged once it is posted."""

    class Inbox:
        def __init__(self):
            self.items = {p["preset_id"]: p for p in PRESETS}
            self.acked = []

        def pending(self):
            return sorted(self.items.items())

        def ack(self, key):
            self.acked.append(key)

    class Outbox:
        posted = []

        def post(self, chunk):
            self.posted.append(chunk)
            return "memory"

    inbox, outbox = Inbox(), Outbox()
    chunks = wk.run_worker(inbox, outbox, once=True, tiny=True, device="cpu", log=lambda s: None)
    assert inbox.acked == [p["preset_id"] for p in PRESETS]
    assert [c.preset_id for c in outbox.posted] == inbox.acked == [c.preset_id for c in chunks]
    assert all(np.isfinite(c.embedding).all() and len(c.embedding) == 128 for c in chunks)
