"""Package rules of the PyTorch port: what it imports, where it runs, how
weights cross over, and that nothing needs nvcc or a card until a kernel
is launched."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mptpu_torch
from mptpu_torch import convert, kernels
from mptpu_torch.device import default_device, no_tf32, parity_mode

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "mptpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "tools").glob("*.py")))


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_mptpu(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "mptpu", "flax", "optax"), f"{path}: imports {name}"


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            default_device()
        with pytest.raises(RuntimeError):
            default_device("cuda:0")
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cpu")).type == "cpu"


def test_tf32_switches():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        with no_tf32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        parity_mode()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("shape", [(16, 128), (8, 2, 64)])
def test_dictionary_round_trip_is_exact(shape):
    d = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    for src in (d, jnp.asarray(d)):
        t = convert.dictionary_from_jax(src, device="cpu")
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), d)
    with pytest.raises(ValueError):
        convert.dictionary_from_jax(d.reshape(-1), device="cpu")


def test_params_from_numpy_keeps_structure_and_values():
    rng = np.random.default_rng(4)
    tree = {
        "enc": {"w": rng.standard_normal((3, 4)).astype(np.float32), "b": jnp.zeros(4)},
        "layers": [np.arange(5, dtype=np.int32), (np.float32(2.5), "tag")],
        "none": None,
    }
    out = convert.params_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(out["enc"]["w"].numpy(), tree["enc"]["w"])
    np.testing.assert_array_equal(out["enc"]["b"].numpy(), np.zeros(4, np.float32))
    assert out["layers"][0].dtype == torch.int32
    assert isinstance(out["layers"][1], tuple) and out["layers"][1][1] == "tag"
    assert float(out["layers"][1][0]) == 2.5
    assert out["none"] is None


def test_launch_counters_stay_zero_on_cpu():
    from mptpu_torch.sparse import sparse_code_fast

    kernels.reset_launches()
    rng = np.random.default_rng(5)
    sig = torch.from_numpy(rng.standard_normal((3, 1, 512)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    from mptpu_torch.probes import probe_launches

    sparse_code_fast(sig, d, n_steps=2, block=128, fused=True, whole_loop=True)
    sparse_code_fast(sig, d, n_steps=2, block=128, fused=True)   # pipelined by default
    sparse_code_fast(sig, d, n_steps=2, block=128, fused=True, whole_loop=True, lane_table=True,
                     depth=1)
    probe_launches("grid", True, steps=3, device="cpu")
    assert set(kernels.LAUNCHES) >= {"cuda_fused_step_pipelined", "cuda_fused_encode_lane",
                                     "probe_launches"}
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}
    assert kernels._lib is None   # nothing was built


def test_importing_the_port_needs_no_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = (
        "import mptpu_torch, mptpu_torch.kernels, mptpu_torch.sparse, mptpu_torch.ops, "
        "mptpu_torch.convert, mptpu_torch.probes, mptpu_torch.sparse.multiband, "
        "mptpu_torch.models, mptpu_torch.train, mptpu_torch.losses, mptpu_torch.nn; "
        "print(mptpu_torch.kernels._lib is None)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
    assert "__init__" in mptpu_torch.__file__


def extern_c_arities():
    """{name: parameter count} of every extern "C" function in the port's
    CUDA sources."""
    found = {}
    for src in sorted((REPO / "mptpu_torch" / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = len(params)
    return found


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_c_signatures_match_the_sources(name):
    """Each entry of kernels._SIGNATURES has as many argument types as its
    extern "C" function has parameters (a missing one would cut a pointer or
    shift every argument after it on the card), and no C entry lacks one."""
    arities = extern_c_arities()
    assert set(arities) == set(kernels._SIGNATURES)
    assert len(kernels._SIGNATURES[name]) == arities[name]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("a card is present: chip_smoke.py would run for real")
        script = REPO / "chip_smoke.py"
    else:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(REPO / "chip_smoke.py", script)
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("kind", ["elementwise", "vectorwise"])
def test_sparsity_from_flax_round_trip(kind):
    """mptpu's flax parameters copied into the port's module give mptpu's
    outputs (rtol 1e-4 / atol 1e-5; top-k indices identical); a tree of
    other layers or shapes is refused."""
    import jax

    from mptpu import sparse as jsp
    from mptpu_torch import sparse as tsp

    x = np.random.default_rng(6).standard_normal((2, 8, 32)).astype(np.float32)
    if kind == "elementwise":
        jm = jsp.ElementwiseSparsity(model_dim=8, high_dim=32, keep=4)
        tm = tsp.ElementwiseSparsity(model_dim=8, high_dim=32, keep=4, device="cpu")
    else:
        jm = jsp.VectorwiseSparsity(model_dim=8, keep=3, channels_last=False)
        tm = tsp.VectorwiseSparsity(model_dim=8, keep=3, channels_last=False, device="cpu")
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    assert convert.module_from_flax(tm, variables) is tm
    for name, leaf in variables["params"].items():
        np.testing.assert_array_equal(getattr(tm, name).weight.detach().numpy(),
                                      np.asarray(leaf["kernel"]).T)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-5)
    if kind == "elementwise":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    with pytest.raises(ValueError):
        convert.module_from_flax(tm, {"Dense_5": variables["params"]["Dense_0"]})
    bad = {k: {"kernel": np.zeros((3, 3)), "bias": np.zeros(3)} for k in variables["params"]}
    with pytest.raises(ValueError):
        convert.module_from_flax(tm, {"params": bad})
