"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits of size, and every name found as a file."""

import json
import re
from pathlib import Path

import pytest

from portbench import run

BENCH = run.load_json(run.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", KEYS)
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        optional = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | optional, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "per_layer":
            assert LINE.match(e["layer"])


def test_metrics():
    sources = {"device_trace", "program_span", "program_counter", "host_clock"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in sources and m["moves"] in e2e
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    used = set()
    for w in cells:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        used.add(w["config"])
        spec = run.load_spec(w["name"])
        e2e = [m["name"] for m in spec.end_to_end()]
        assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer()
        for m in spec.end_to_end():
            assert (run.HERE / "e2e" / f"{m['name']}.py").is_file()
        for m in spec.per_layer():
            assert run.reader_path(m["name"]).is_file(), m["name"]
        assert spec.limits and all(v > 0 for v in spec.limits.values())
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (run.CHECKOUT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_file_names_under_paths():
    for path in Path(run.HERE).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(run.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
