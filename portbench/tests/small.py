"""Each cell at a size a CPU test holds: its traffic mix, entry and limits
as committed, its configuration's widths cut down."""

from __future__ import annotations

import importlib

import torch

from portbench import run

CONFIGS = {
    "mp-512x512-16k": dict(n_atoms=16, atom_size=128, n_samples=1024, n_steps=8,
                           engine=dict(fused=True, pipelined=True, whole_loop=True, block=128,
                                       depth=3)),
    "multiband-7x512x128": dict(sizes=[512, 1024, 2048], n_atoms=16, atom_size=128,
                                n_samples=2048, n_steps=6, samplerate=22050),
}
TRAFFIC = {
    "encode_b32": dict(batch=4, pool=3, checked_calls=2, traced_calls=3),
    "encode_b4": dict(pool=3, checked_calls=2, traced_calls=3),
    "multiband_b4": dict(batch=2, pool=3, checked_calls=2, traced_calls=3),
    "learn_b64": dict(batch=4, pool=5, traced_calls=2),
}
CPU = torch.device("cpu")


def cells() -> list[str]:
    return [w["name"] for w in run.load_json(run.CHECKOUT / "BENCHMARK.json")["workloads"]]


def controls() -> list[tuple[str, str]]:
    """(cell, control) for every control of every cell's entry."""
    out = []
    for name in cells():
        entry = run.load_spec(name).entry
        out += [(name, control) for control in entry.CONTROLS]
    return out


def spec(name: str) -> run.Spec:
    full = run.load_spec(name)
    traffic = dict(full.traffic, **TRAFFIC[full.cell["traffic"]])
    return run.Spec(full.bench, full.cell, CONFIGS[full.cell["config"]], traffic, full.limits,
                    importlib.import_module(f"portbench.entries.{traffic['entry']}"))
