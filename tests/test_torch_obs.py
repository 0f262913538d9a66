"""The logged-value collection and the live dashboard (``mptpu/obs/
collection.py``, ``server.py``) in the port against ``mptpu``: what one
package logs the other reads (the same sqlite keys and encodings), the
loggers, and ``serve_collection`` on a loopback port, whose endpoints
answer as ``mptpu``'s do. Also a rehearsal of ``chip_smoke.py``'s phase 9
on the CPU at ``--tiny``'s size.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mptpu.obs import collection as jcol
from mptpu.obs import server as jserver
from mptpu_torch.obs import Collection, encode_audio, loggers, serve_collection


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work: the tier-1 run puts
    six test processes on one machine, where PyTorch's default of a thread
    a core makes every process wait on descheduled threads."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def log_all(col, rng):
    col.log("curve", rng.standard_normal(5).astype(np.float32))
    col.log("curve", rng.standard_normal(7).astype(np.float32))
    col.log("gain", 0.25, kind="scalar")
    col.log("clip", 0.5 * np.sin(np.arange(2205) / 7.0), kind="audio", samplerate=22050)


@pytest.mark.parametrize("writer", ["port", "mptpu"])
def test_collection_across_packages(tmp_path, writer):
    """Values logged by one package read back identically in the other:
    arrays, scalars, WAV bytes, meta (kind, count, samplerate) and the
    names."""
    path = str(tmp_path / "dash")
    rng = np.random.default_rng(0)
    w = Collection(path) if writer == "port" else jcol.Collection(path)
    log_all(w, rng)
    r = jcol.Collection(path) if writer == "port" else Collection(path)
    assert r.names() == ["clip", "curve", "gain"]
    np.testing.assert_array_equal(r.latest("curve"), w.latest("curve"))
    assert r.latest("curve").shape == (7,)
    assert float(r.latest("gain")) == 0.25
    assert bytes(r.latest("clip")) == jcol.encode_audio(0.5 * np.sin(np.arange(2205) / 7.0))
    for name, kind, count in (("curve", "array", 1), ("gain", "scalar", 0), ("clip", "audio", 0)):
        meta = r.meta(name)
        assert (meta["kind"], meta["count"], meta["samplerate"]) == (kind, count, 22050)


def test_collection_takes_tensors_and_loggers(tmp_path):
    """The port's Collection logs a tensor as its numpy value; loggers
    gives one callable per name, audio when the kind says so, as mptpu's."""
    col = Collection(str(tmp_path / "dash"))
    col.log("t", torch.arange(4.0))
    np.testing.assert_array_equal(col.latest("t"), np.arange(4.0, dtype=np.float32))
    jc = jcol.Collection(str(tmp_path / "jdash"))
    for c, make in ((col, loggers), (jc, jcol.loggers)):
        orig, recon = make(["orig", "recon"], "audio", c)
        orig(np.zeros(10))
        recon(np.ones(10) * 0.5)
        (curve,) = make(["loss"], "array", c)
        curve(np.arange(3.0))
    for name in ("orig", "recon", "loss"):
        assert col.meta(name)["kind"] == jc.meta(name)["kind"]
    for name in ("orig", "recon"):
        assert bytes(col.latest(name)) == bytes(jc.latest(name))
    np.testing.assert_array_equal(col.latest("loss"), jc.latest("loss"))
    assert encode_audio(np.array([np.nan, 2.0, -2.0])) == jcol.encode_audio(
        np.array([np.nan, 2.0, -2.0]))


def fetch(server, path):
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_serve_collection_on_a_loopback_port(tmp_path):
    """Both packages' servers on a free loopback port answer every endpoint
    with the same bytes (the page, names, meta but its time, values, WAV)
    and 404 an unknown name; shutdown stops them."""
    path = str(tmp_path / "dash")
    log_all(Collection(path), np.random.default_rng(1))
    servers = [serve_collection(Collection(path), port=0, host="127.0.0.1")]
    kept = jserver.ThreadingHTTPServer

    class Loopback(kept):
        def __init__(self, address, handler):
            super().__init__(("127.0.0.1", 0), handler)

    jserver.ThreadingHTTPServer = Loopback   # mptpu's binds every address
    try:
        servers.append(jserver.serve_collection(jcol.Collection(path), port=0))
    finally:
        jserver.ThreadingHTTPServer = kept
    try:
        answers = []
        for srv in servers:
            got = {p: fetch(srv, p) for p in ("/", "/api/names", "/api/value/curve",
                                             "/api/value/clip", "/api/value/gain")}
            meta = json.loads(fetch(srv, "/api/meta/curve")[2])
            meta.pop("time")
            got["meta"] = meta
            with pytest.raises(urllib.error.HTTPError) as err:
                fetch(srv, "/api/meta/nothing")
            got["404"] = err.value.code
            answers.append(got)
        assert answers[0] == answers[1]
        assert answers[0]["/api/value/clip"][1] == "audio/wav"
        assert json.loads(answers[0]["/api/value/curve"][2])["shape"] == [7]
        assert answers[0]["404"] == 404
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_chip_smoke_siam_train_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 9 at --tiny's size on the CPU: the overfit
    trainer with an eval and a walk eval, the CPU against itself, the
    injected non-finite step, train_and_monitor through the data-parallel
    step on one gloo rank (its own temporary MPTPU_CACHE), no kernel
    launched."""
    import chip_smoke
    from mptpu_torch.sparse import quantize

    chip_smoke.siam_train_phase(torch.device("cpu"), chip_smoke.SIAM_TRAIN_SMALL, lambda: None)
    assert (quantize.RELU_SELECTION_LEAK, quantize.RELU_SELECTION_FLOOR) == (0.0, 0.0)
