"""The port's boundaries: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU, its kernel build fails loudly
without nvcc, and ``chip_smoke.py`` fails without a card. The kernel-vs-plain
tests marked ``gpu`` run on the card (this file imports no JAX at module
level, so on a machine without JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_port.py``)."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.kernels import build
from repro_torch.kernels import gbn as K
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.relative_to(ROOT)} imports {mod}"
    defs = [n.name for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert not [d for d in defs if d.endswith("_pallas")]


def test_importing_the_port_leaves_jax_out():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'repro.')) or m == 'repro'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    from repro_torch import convert
    from repro_torch.configs import F1_MNIST, RESNET44_CIFAR10
    from repro_torch.core import Regime, presets
    from repro_torch.data import teacher_classification
    from repro_torch.device import resolve_device
    from repro_torch.models.cnn import model_fns
    from repro_torch.train.trainer import train_vision
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(F1_MNIST, input_shape=(4, 4, 1),
                              hidden_sizes=(8,))
    data = teacher_classification(0, n_train=64, n_test=16,
                                  input_shape=(4, 4, 1))
    lb = presets(32, 16, 16)["LB+LR+GBN+RA"]
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: train_vision(model_fns(cfg), cfg, data, lb,
                             Regime(0.1, 2, 1)),
        lambda: model_fns(cfg)[0](0, cfg),
        lambda: model_fns(RESNET44_CIFAR10)[0](0, RESNET44_CIFAR10),
        lambda: convert.to_torch({"w": np.zeros(3, np.float32)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(empty))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", empty)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("gbn.cu")
    assert not (tmp_path / "build").exists()


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="refused"):
        build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_source():
    p = build.library_path("gbn.cu")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libgbn-")
    assert (build.CSRC / "gbn.cu").is_file()


def test_synthetic_data_matches_reference():
    from repro.data.synthetic import teacher_classification as jdata
    from repro_torch.data import teacher_classification as tdata
    for kw in (dict(n_train=64, n_test=32, input_shape=(4, 4, 3)),
               dict(n_train=100, n_test=10, input_shape=(28, 28, 1),
                    label_noise=0.2)):
        a, b = tdata(3, **kw), jdata(3, **kw)
        for f in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_tree_order_is_sorted_keys_then_list_order():
    t = {"b": [1, {"z": 2, "a": 3}], "a": 4, "c": None}
    assert tree.leaves(t) == [4, 1, 3, 2]
    assert tree.unflatten(t, [10, 20, 30, 40]) == \
        {"a": 10, "b": [20, {"a": 30, "z": 40}], "c": None}
    assert tree.map(lambda x, y: x + y, t, t) == \
        {"a": 8, "b": [2, {"a": 6, "z": 4}], "c": None}
    with pytest.raises(ValueError):
        tree.map(lambda x, y: x, t, {"a": 1})


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_inputs(shape, seed):
    G, R, C = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    return (2.0 * randn(G, R, C) + 0.5,
            torch.linspace(0.5, 1.5, C, device="cuda"),
            torch.linspace(-1.0, 1.0, C, device="cuda"),
            (randn(G, R, C), randn(G, C), randn(G, C)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 77, 200), (1, 16, 8), (2, 33, 10),
                                   (4, 300, 96), (32, 8192, 64)])
def test_cuda_kernels_match_plain(shape):
    """The CUDA pair against its plain version on the card (f32, 1e-4;
    dgamma/dbeta relative to their largest entry: they sum G*R rows in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, gamma, beta, (dy, dmu, dvar) = _cuda_inputs(shape, sum(shape))
    K.reset_launches()
    y, mu, var = K.gbn_forward(x, gamma, beta)
    for a, b in zip((y, mu, var), tref.gbn_ref(x, gamma, beta)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    dx, dg, db = K.gbn_backward(x, gamma, mu, var, dy, dmu, dvar)
    rdx, rdg, rdb = tref.gbn_backward_ref(x, gamma, mu, var, dy, dmu, dvar)
    torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-4)
    for a, b in ((dg, rdg), (db, rdb)):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))
    assert K.launches == {"gbn_forward": 1, "gbn_backward": 1}


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, gamma, beta, _ = _cuda_inputs((2, 16, 8), 0)
    with pytest.raises(TypeError):
        K.gbn_forward(x.double(), gamma, beta)
    with pytest.raises(ValueError):
        K.gbn_forward(x.transpose(1, 2), gamma, beta)
    with pytest.raises(ValueError):
        K.gbn_forward(x, gamma.cpu(), beta)
