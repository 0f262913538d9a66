"""The port's layer spans (``mptpu_torch/tracing.py``) on the CPU at small
shapes, and the benchmark's reading of them and of the host's waits inside
them (``portbench/spans.py``) on hand-built traces."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mptpu_torch import tracing
from mptpu_torch.ops.fft import real_ends
from mptpu_torch.sparse import BandSpec, MultibandDictionaryLearning
from mptpu_torch.sparse.fast_mp import sparse_code_fast
from mptpu_torch.sparse.matching_pursuit import dictionary_learning_step
from mptpu_torch.utils import profile
from portbench import run, spans
from portbench.tracing import read_chrome_trace

REPO = Path(__file__).resolve().parent.parent
SIZES = [512, 1024, 2048]
SPANNED = ("sparse/fast_mp.py", "sparse/multiband.py", "sparse/matching_pursuit.py")
ENGINES = {
    "whole_loop": dict(fused=True, whole_loop=True, depth=1),
    "pipelined": dict(fused=True),
    "steps": dict(block_argmax=True),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def signal(batch=3, n=1024, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, 1, n)).astype(np.float32))


def dictionary(n_atoms=16, atom_size=128, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n_atoms, atom_size)).astype(np.float32))


def multiband():
    gen = torch.Generator().manual_seed(2)
    return MultibandDictionaryLearning(
        [BandSpec(s, 8, 128, signal_samples=SIZES[-1], is_lowest_band=(s == SIZES[0]),
                  d=torch.rand((8, 128), generator=gen) - 0.5) for s in SIZES],
        n_samples=SIZES[-1],
    )


def traced_spans(tmp_path, fn):
    """(fn's result, [(name, start, end)] of the program's spans in order)."""
    with profile.trace(str(tmp_path)) as path:
        out = fn()
    events = json.loads(Path(path).read_text())["traceEvents"]
    found = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("mptpu."))
    return out, [(name, t0, t1) for t0, t1, name in found]


def names(found):
    return [name for name, _, _ in found]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def assert_disjoint(found):
    for a, b in zip(found, found[1:]):
        assert a[2] <= b[1], (a, b)


@pytest.mark.parametrize("engine", ENGINES)
def test_an_encode_opens_gram_state_loop_once(tmp_path, engine):
    _, found = traced_spans(tmp_path, lambda: sparse_code_fast(
        signal(), dictionary(), n_steps=4, block=128, **ENGINES[engine]))
    assert names(found) == ["mptpu.mp.gram", "mptpu.mp.state", "mptpu.mp.loop"]
    assert_disjoint(found)


def test_a_multiband_encode_splits_once_then_codes_each_band(tmp_path):
    model = multiband()
    _, found = traced_spans(tmp_path, lambda: model.encode(signal(2, SIZES[-1]), 4))
    assert names(found) == ["mptpu.multiband.split"] + [
        "mptpu.mp.gram", "mptpu.mp.state", "mptpu.mp.loop"] * len(SIZES)
    assert_disjoint(found)


def test_a_learning_step_codes_then_groups_then_updates(tmp_path):
    _, found = traced_spans(tmp_path, lambda: dictionary_learning_step(
        signal(), dictionary(), n_steps=4))
    assert names(found) == ["mptpu.mp.gram", "mptpu.mp.state", "mptpu.mp.loop",
                            "mptpu.learn.groups", "mptpu.learn.update"]
    assert_disjoint(found)


def test_a_multiband_learn_nests_nothing_in_the_split(tmp_path):
    model = multiband()
    _, found = traced_spans(tmp_path, lambda: model.learn(signal(2, SIZES[-1]), 4))
    step = ["mptpu.mp.gram", "mptpu.mp.state", "mptpu.mp.loop", "mptpu.learn.groups",
            "mptpu.learn.update"]
    assert names(found) == ["mptpu.multiband.split"] + step * len(SIZES)
    assert_disjoint(found)


def test_the_spans_nest_inside_the_callers_annotation(tmp_path):
    def call():
        with torch.profiler.record_function("caller"):
            return sparse_code_fast(signal(), dictionary(), n_steps=2, block=128, fused=True)

    with profile.trace(str(tmp_path)) as path:
        call()
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    caller = next((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"] == "caller")
    mine = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e["name"].startswith("mptpu.")]
    assert len(mine) == 3 and all(inside(s, caller) for s in mine)


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for engine in ENGINES.values():
        sparse_code_fast(signal(), dictionary(), n_steps=2, block=128, **engine)
    dictionary_learning_step(signal(), dictionary(), n_steps=2)
    model = multiband()
    model.encode(signal(2, SIZES[-1]), 2)
    model.learn(signal(2, SIZES[-1]), 2)
    assert tracing.span("mptpu.mp.gram") is tracing.span("mptpu.learn.update")


def test_the_profiler_changes_no_result(tmp_path):
    def results():
        out = {}
        for key, engine in ENGINES.items():
            out[key] = tuple(sparse_code_fast(signal(), dictionary(), n_steps=4, block=128,
                                              **engine))
        out["learn"] = (dictionary_learning_step(signal(), dictionary(), n_steps=4),)
        model = multiband()
        coded = model.encode(signal(2, SIZES[-1]), 4)
        out["multiband"] = tuple(t for s in SIZES for t in coded[s])
        model.learn(signal(2, SIZES[-1]), 4)
        out["multiband_learn"] = tuple(model.bands[s].d for s in SIZES)
        return out

    off = results()
    on, _ = traced_spans(tmp_path, results)
    assert set(on) == set(off)
    for key in off:
        for a, b in zip(off[key], on[key], strict=True):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("n", [1, 2, 9])
def test_real_ends_zeroes_only_the_end_imaginary_parts(n):
    """``real_ends`` writes its mask through slices (a fill on a card, no
    wait for it); the numbers are those of writing each end."""
    gen = torch.Generator().manual_seed(n)
    spec = torch.complex(torch.randn(2, n, generator=gen), torch.randn(2, n, generator=gen))
    out = real_ends(spec)
    imag = spec.imag.clone()
    imag[..., 0] = 0.0
    imag[..., -1] = 0.0
    assert torch.equal(out.real, spec.real) and torch.equal(out.imag, imag)


def spans_in_loops(path):
    """Calls of ``span`` inside a ``for`` or ``while`` body of ``path``."""
    tree = ast.parse(path.read_text())
    found = []
    for loop in ast.walk(tree):
        if isinstance(loop, (ast.For, ast.While)):
            for node in ast.walk(loop):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                    found.append(node.lineno)
    return found


def test_every_span_is_named_and_stays_out_of_loops():
    layers = {m["layer"] for m in run.load_json(REPO / "BENCHMARK.json")["per_layer"]}
    assert set(tracing.SPANS.values()) <= layers
    opened = set()
    for rel in SPANNED:
        path = REPO / "mptpu_torch" / rel
        assert spans_in_loops(path) == [], rel
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                opened.add(node.args[0].value)
    assert opened == set(tracing.SPANS)


# --- portbench/spans.py on hand-built traces (microseconds) -----------------

def chrome(events):
    return [dict(ph="X", **e) for e in events]


def made_trace(host, device, window=(0, 1000), calls=2, runtime=()):
    events = [dict(cat="user_annotation", name="portbench.window", ts=window[0],
                   dur=window[1] - window[0])]
    events += [dict(cat="user_annotation", name=n, ts=t0, dur=t1 - t0) for n, t0, t1 in host]
    events += [dict(cat=cat, name=n, ts=t0, dur=t1 - t0) for n, t0, t1, cat in runtime]
    events += [dict(cat="kernel", name=n, ts=t0, dur=t1 - t0) for n, t0, t1 in device]
    return read_chrome_trace(chrome(events), calls, {}, (1.0, 1.0))


def reader(metric):
    return run.module_at("metrics", run.reader_path(metric).stem).read


def test_the_innermost_span_takes_the_idle_time():
    t = made_trace(
        host=[("portbench.call", 0, 1000), ("mptpu.learn.update", 100, 600),
              ("mptpu.mp.loop", 200, 300), ("cudaLaunchKernel", 210, 220)],
        device=[("k", 300, 400), ("k", 700, 900)],
    )
    parts = spans.idle_by_span(t)
    # idle 0-300, 400-700, 900-1000: outside 0-100, 600-700, 900-1000; the
    # update 100-200, 400-600; the loop inside the update 200-300
    assert parts == pytest.approx({"outside": 300e-6, "mptpu.learn.update": 300e-6,
                                   "mptpu.mp.loop": 100e-6})
    assert sum(parts.values()) == pytest.approx(t.window_s - t.busy_s())
    assert reader("encode.loop_idle_ms")(t) == pytest.approx(0.05)       # 100 us over 2 calls
    assert reader("learn.update_idle_ms")(t) == pytest.approx(0.15)
    assert reader("learn.outside_idle_ms")(t) == pytest.approx(0.15)
    assert reader("encode.state_idle_ms")(t) is None                     # no such span


def test_the_parts_sum_to_the_idle_time():
    rng = np.random.default_rng(7)
    host, device = [], []
    for c in range(5):
        base = 200 * c
        host += [("mptpu.multiband.split", base + 5, base + 30),
                 ("mptpu.mp.gram", base + 40, base + 70), ("mptpu.mp.state", base + 70, base + 95),
                 ("mptpu.mp.loop", base + 100, base + 160)]
        for _ in range(6):
            t0 = base + rng.uniform(0, 190)
            device.append(("k", t0, t0 + rng.uniform(1, 40)))
    t = made_trace(host, device, window=(0, 1000), calls=5)
    parts = spans.idle_by_span(t)
    assert sum(parts.values()) == pytest.approx(t.window_s - t.busy_s(), rel=1e-9)
    read = sum(reader(m)(t) for m in ("encode.state_idle_ms", "encode.loop_idle_ms",
                                      "encode.split_idle_ms", "encode.outside_idle_ms"))
    assert read * 5 / 1e3 == pytest.approx(t.window_s - t.busy_s(), rel=1e-9)
    assert reader("encode.grams_per_call")(t) == 1.0


def test_host_time_and_sync_counts():
    rt = "cuda_runtime"
    t = made_trace(
        host=[("mptpu.learn.groups", 100, 150), ("mptpu.learn.update", 150, 450),
              ("mptpu.learn.groups", 500, 540), ("mptpu.learn.update", 540, 740),
              ("mptpu.mp.gram", 10, 20)],
        device=[("k", 0, 100)],
        # two waits in each groups span; the harness's synchronise under no span
        runtime=[("cudaMemcpyAsync", 105, 130, rt), ("cudaStreamSynchronize", 130, 131, rt),
                 ("cudaMemcpyAsync", 132, 135, rt), ("cudaStreamSynchronize", 135, 136, rt),
                 ("cudaStreamSynchronize", 510, 511, rt), ("cudaStreamSynchronize", 520, 521, rt),
                 ("cudaDeviceSynchronize", 745, 990, rt)],
    )
    assert reader("learn.update_host_ms")(t) == pytest.approx(0.25)      # 500 us over 2
    assert reader("learn.host_syncs")(t) == pytest.approx(2.0)           # 4 waits over 2
    assert reader("encode.host_syncs")(t) == pytest.approx(2.0)
    assert reader("encode.grams_per_call")(t) == pytest.approx(0.5)


@pytest.mark.parametrize("call", sorted(spans.SYNC_CALLS))
def test_a_wait_counts_inside_a_span_and_not_outside(call):
    cat = "cuda_driver" if call.startswith("cu") and not call.startswith("cuda") else "cuda_runtime"
    t = made_trace(
        host=[("portbench.call", 0, 1000), ("mptpu.mp.gram", 100, 200),
              ("mptpu.mp.loop", 300, 400)],
        device=[("k", 0, 50)],
        runtime=[(call, 150, 160, cat), (call, 350, 351, cat), (call, 500, 600, cat),
                 ("cudaLaunchKernel", 120, 121, "cuda_runtime"),
                 ("cudaMemcpyAsync", 310, 320, "cuda_runtime")],
        calls=1,
    )
    assert spans.waits(t) == 2.0
    assert reader("encode.host_syncs")(t) == 2.0


def test_no_wait_reads_zero_and_a_span_free_trace_none():
    rt = "cuda_runtime"
    spanned = made_trace(host=[("mptpu.mp.loop", 100, 200)], device=[("k", 0, 50)],
                         runtime=[("cudaLaunchKernel", 110, 111, rt),
                                  ("cudaDeviceSynchronize", 300, 400, rt)])
    assert reader("encode.host_syncs")(spanned) == 0.0
    bare = made_trace(host=[("portbench.call", 0, 1000)], device=[("k", 0, 50)],
                      runtime=[("cudaStreamSynchronize", 100, 101, rt)])
    assert reader("learn.host_syncs")(bare) is None


def test_a_window_without_program_spans_is_all_outside():
    t = made_trace(host=[("portbench.call", 0, 1000), ("aten::mul", 100, 200)],
                   device=[("k", 100, 400)])
    assert spans.idle_by_span(t) == pytest.approx({"outside": 700e-6})
    for metric in ("encode.grams_per_call", "encode.state_idle_ms", "encode.loop_idle_ms",
                   "encode.split_idle_ms", "learn.update_host_ms", "learn.update_idle_ms",
                   "learn.sync_idle_ms", "encode.host_syncs", "learn.outside_idle_ms"):
        assert reader(metric)(t) is None, metric


def test_a_trace_without_device_reads_nothing():
    t = made_trace(host=[("mptpu.mp.gram", 0, 10)], device=[])
    assert reader("encode.grams_per_call")(t) is None
    assert reader("encode.outside_idle_ms")(t) is None
