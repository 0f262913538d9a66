"""The result line's schema on a CPU run, and the trace's reading on a
made-up Chrome trace."""

import json

import pytest

from portbench import run, tracing
from portbench.tests.small import CPU, cells, spec


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", cells())
def test_result_line(name, trace):
    s = spec(name)
    result = run.execute(s, 2**31 + 99, 0.3, trace, CPU)
    line = json.dumps(result, allow_nan=False)
    back = json.loads(line)
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(back)
    assert back["correct"] is True and back["failed"] == 0 and back["attempted"] >= 1
    assert set(back["checks"]) == set(s.limits)
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    dev = back["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run traces no device: no device metric is written
        assert back["metrics"] == {}
    else:
        want = {m["name"] for m in s.end_to_end()}
        assert set(back["metrics"]) == want
        for m in back["metrics"].values():
            assert m["value"] > 0 and m["unit"]


def chrome(events):
    return [dict(ph="X", **e) for e in events]


def test_trace_reading():
    events = chrome([
        dict(cat="user_annotation", name=tracing.WINDOW, ts=0, dur=1000),
        dict(cat="user_annotation", name=tracing.CALL, ts=0, dur=500),
        dict(cat="cuda_runtime", name="cudaStreamSynchronize", ts=600, dur=300),
        dict(cat="kernel", name="fused_step_pipelined_kernel(float*, int)", ts=100, dur=200),
        dict(cat="kernel", name="fused_step_pipelined_kernel(float*, int)", ts=250, dur=150),
        dict(cat="kernel", name="void at::native::reduce_kernel<512, 1>(int)", ts=500, dur=100),
        dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=950, dur=100),
    ])
    t = tracing.read_chrome_trace(events, calls=2,
                                  needed=dict(flops=67e6, loop_bytes=3.35e3, loop_flops=0),
                                  peaks=(3.35e12, 67e12))
    assert t.window_s == pytest.approx(1e-3)
    assert t.kernel_s(tracing.K4) == pytest.approx(300e-6)    # the chain's union, not 350
    assert t.kernel_count(tracing.K4) == 2 and t.kernel_count() == 3
    assert t.busy_s() == pytest.approx(450e-6)                 # the copy cut at the window
    assert t.idle_pct() == pytest.approx(55.0)
    assert t.kernel_roofline(tracing.K4) == pytest.approx(100 * 1e-9 / 300e-6)
    assert t.kernel_roofline(tracing.K2) is None
    assert t.mfu() == pytest.approx(100 * 67e6 / (1e-3 * 67e12))
    ops = dict(t.device_ops())
    assert ops["fused_step_pipelined_kernel(float*, int)"] == pytest.approx(350e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["portbench.call"] == pytest.approx(200e-6)       # 0..100, 400..500
    assert gaps["cudaStreamSynchronize"] == pytest.approx(350e-6)  # 600..950
    assert sum(gaps.values()) == pytest.approx(550e-6)


def test_trace_without_device_reads_nothing():
    events = chrome([dict(cat="user_annotation", name=tracing.WINDOW, ts=0, dur=10)])
    t = tracing.read_chrome_trace(events, 1, dict(flops=1.0), (1.0, 1.0))
    assert t.idle_pct() is None and t.mfu() is None and t.kernel_roofline(tracing.K2) is None


def test_base_names():
    assert tracing.base_name("fused_encode_kernel(float*, int)") == "fused_encode_kernel"
    assert tracing.base_name("void ns::k<1, 2>(int)") == "k"
