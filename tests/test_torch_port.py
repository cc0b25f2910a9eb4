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

from _mamba_plan_model import model_plan, owners
from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro_torch import tree
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import gbn as K
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swiglu as SW

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
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import ContinuousEngine, generate
    lm = get_config("qwen3-1.7b-reduced")
    lm_params = TT.init_params(0, lm, device="cpu")
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: train_vision(model_fns(cfg), cfg, data, lb,
                             Regime(0.1, 2, 1)),
        lambda: model_fns(cfg)[0](0, cfg),
        lambda: model_fns(RESNET44_CIFAR10)[0](0, RESNET44_CIFAR10),
        lambda: convert.to_torch({"w": np.zeros(3, np.float32)}),
        lambda: convert.lm_to_torch({"w": np.zeros(3, np.float32)}, lm),
        lambda: TT.init_params(0, lm),
        lambda: TT.init_cache(lm, 2, 8),
        lambda: TT.init_cache(lm, 2, 16, layout="paged", page_size=8),
        lambda: TT.init_cache(lm, 2, 16, layout="paged", page_size=8,
                              cache_dtype="int8"),
        lambda: generate(lm_params, lm, np.zeros((2, 4), np.int64),
                         max_new_tokens=2),
        lambda: ContinuousEngine(lm_params, lm, num_slots=2, max_len=16,
                                 page_size=8),
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


@pytest.mark.parametrize("source", build.SOURCES)
def test_every_source_has_its_own_library(source):
    p = build.library_path(source)
    stem = source.removesuffix(".cu")
    assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{stem}-")
    assert (build.CSRC / source).is_file()


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """A change to a shared ``.cuh`` header renames every library, so a
    stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("swiglu.cu")
    (csrc / "common.cuh").write_text("// changed\n")
    assert build.library_path("swiglu.cu") != before


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


# the four ResNet44/F1 path shapes (B=4096, ghost 128), ragged shapes
# (R not a multiple of P or of the slice rows; C not a multiple of 4), and
# (2, 2**19, 16), a ghost over the persistent body's budget (two-pass body)
GBN_CARD_SHAPES = [(3, 77, 200), (1, 16, 8), (2, 33, 10), (4, 300, 96),
                   (32, 8192, 64), (32, 131072, 16), (32, 32768, 32),
                   (32, 128, 512), (7, 1001, 24), (5, 263, 12),
                   (2, 2 ** 19, 16)]


def _gbn_check(x, gamma, beta, dy, dmu, dvar, fwd, bwd):
    """fwd/bwd (the wrappers, or one body) against the plain versions at
    1e-4 (dgamma/dbeta relative to their largest entry: they sum G*R rows
    in another order); returns the outputs."""
    y, mu, var = fwd(x, gamma, beta)
    for a, b in zip((y, mu, var), tref.gbn_ref(x, gamma, beta)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    dx, dg, db = bwd(x, gamma, mu, var, dy, dmu, dvar)
    rdx, rdg, rdb = tref.gbn_backward_ref(x, gamma, mu, var, dy, dmu, dvar)
    torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-4)
    for a, b in ((dg, rdg), (db, rdb)):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))
    return y, mu, var, dx, dg, db


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GBN_CARD_SHAPES)
def test_cuda_kernels_match_plain(shape):
    """The CUDA pair against its plain version on the card, through the
    body the plan picks, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, gamma, beta, (dy, dmu, dvar) = _cuda_inputs(shape, sum(shape))
    K.reset_launches()
    _gbn_check(x, gamma, beta, dy, dmu, dvar, K.gbn_forward, K.gbn_backward)
    assert K.launches == {"gbn_forward": 1, "gbn_backward": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GBN_CARD_SHAPES)
def test_cuda_gbn_bodies_match_plain_and_repeat_bit_for_bit(shape):
    """Both bodies (the persistent one also under other constants) against
    the plain versions where each takes the shape; two calls of a body on
    the same inputs give the same bits; the plan picks the persistent body
    on the path's shapes and the two-pass body past the budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    G, R, C = shape
    sms = K.sm_count(torch.cuda.current_device())
    plans = {b: K.plan(G, R, C, sms, backward=b) for b in (False, True)}
    want = "two_pass" if R == 2 ** 19 else "persistent"
    assert {p.body for p in plans.values()} == {want}
    x, gamma, beta, (dy, dmu, dvar) = _cuda_inputs(shape, 3 * sum(shape))
    # other constants: two blocks an SM, slices of a third of a ring
    other = {b: K.plan(G, R, C, sms, backward=b, blocks_per_sm=2, depth=3)
             for b in (False, True)}
    for pf, pb in ((plans[False], plans[True]),
                   (other[False], other[True]),
                   (K.two_pass(G, R, C), K.two_pass(G, R, C))):
        def fwd(*a):
            return K.forward_with(pf, *a)

        def bwd(*a):
            return K.backward_with(pb, *a)
        first = _gbn_check(x, gamma, beta, dy, dmu, dvar, fwd, bwd)
        again = fwd(x, gamma, beta) + bwd(x, gamma, *first[1:3], dy, dmu,
                                         dvar)
        assert all(a.equal(b) for a, b in zip(first, again)), pf.body


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 77, 200), (2, 33, 10), (7, 1001, 24)])
def test_cuda_gbn_unaligned_inputs_match_plain(shape):
    """Views that start 4 and 12 bytes past a 16-byte boundary take the
    one-channel accesses, and the persistent body copies each sub-chunk's
    unaligned head and tail itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, gamma, beta, (dy, dmu, dvar) = _cuda_inputs(shape, 5)

    def shifted(t, k):
        buf = torch.empty(t.numel() + k, device="cuda")
        buf[k:] = t.flatten()
        return buf[k:].view(t.shape)
    xu, dyu = shifted(x, 1), shifted(dy, 3)
    assert K.plan(*shape, K.sm_count(torch.cuda.current_device()),
                  backward=True, aligned=False).body == "persistent"
    _gbn_check(xu, gamma, beta, dyu, dmu, dvar, K.gbn_forward,
               K.gbn_backward)


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
    # a plan of 16-byte accesses on a misaligned view
    xu = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    p = K.plan(*x.shape, K.sm_count(torch.cuda.current_device()),
               backward=False)
    with pytest.raises(ValueError):
        K.forward_with(p, xu, gamma, beta)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16_tol(dtype):
    """f32: 1e-4 (tests/test_fused_kernels.py). bf16: the kernel and its
    plain version read the same bf16 inputs and round their output once
    (the plain rmsnorm/swiglu also round intermediates), so they differ by
    a few bf16 ulps: 2e-2, the reference tests' bf16 bound."""
    return 1e-4 if dtype == torch.float32 else 2e-2


SERVING_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape", [(17, 128), (64, 2048), (5, 100), (3, 7),
                                   (64, 3840), (64, 5376), (64, 8192)])
def test_cuda_rmsnorm_residual_matches_plain(shape, dtype):
    gen = _on_card()
    x, r = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = torch.linspace(0.5, 1.5, shape[1], device="cuda")
    FN.reset_launches()
    got = FN.rmsnorm_residual(x, r, scale)
    want = tref.rmsnorm_residual_ref(x, r, scale)
    tol = _bf16_tol(dtype)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    assert FN.launches == {"rmsnorm_residual": 1,
                           "rmsnorm_residual_backward": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape", [(17, 128), (64, 2048), (5, 100), (3, 7)])
def test_cuda_rmsnorm_without_residual_matches_plain(shape, dtype):
    """``r=None``: within tolerance of the plain version, bit-equal to the
    kernel with a zero residual, s is x, one launch."""
    gen = _on_card()
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    scale = torch.linspace(0.5, 1.5, shape[1], device="cuda")
    FN.reset_launches()
    y, s = FN.rmsnorm_residual(x, None, scale)
    assert s is x
    assert FN.launches == {"rmsnorm_residual": 1,
                           "rmsnorm_residual_backward": 0}
    want, _ = tref.rmsnorm_residual_ref(x, None, scale)
    tol = _bf16_tol(dtype)
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(y, FN.rmsnorm_residual(x, torch.zeros_like(x),
                                              scale)[0])


# SwiGLU shapes (N, d, F) of the card tests. bf16 takes the wgmma body at
# all but (5, 100, 72) (d not a multiple of 8: the FMA body); (128, 64,
# 128) is one 128 x 128 tile one stage deep; (77, 512, 1000) has ragged N
# and F; (4096, 2048, 6144) is qwen3-1.7b's training call.
SWIGLU_SHAPES = [(9, 128, 256), (33, 256, 384), (5, 100, 72), (130, 64, 200),
                 (128, 64, 128), (77, 512, 1000), (4096, 2048, 6144)]


@pytest.mark.parametrize("d,F,dtype,body", [
    (2048, 6144, torch.bfloat16, "wgmma"), (64, 200, torch.bfloat16, "wgmma"),
    (8, 8, torch.bfloat16, "wgmma"), (100, 72, torch.bfloat16, "fma"),
    (2048, 6148, torch.bfloat16, "fma"), (2048, 6144, torch.float32, "fma"),
])
def test_swiglu_body_follows_widths_and_dtype_only(d, F, dtype, body):
    """The body is a function of (d, F, dtype): N is not an argument, so a
    row takes the same body, tiles and sums at every batch size."""
    import inspect
    assert list(inspect.signature(SW._body).parameters) == ["d", "F",
                                                            "dtype"]
    assert SW._body(d, F, dtype) == body


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape", SWIGLU_SHAPES)
def test_cuda_swiglu_matches_plain(shape, dtype):
    gen = _on_card()
    N, d, F = shape
    x = torch.randn(N, d, generator=gen, device="cuda").to(dtype)
    wg, wu = ((torch.randn(d, F, generator=gen, device="cuda")
               / d ** 0.5).to(dtype) for _ in range(2))
    SW.reset_launches()
    h, g = SW.swiglu(x, wg, wu)
    hr, gr = tref.swiglu_ref(x, wg, wu)
    tol = _bf16_tol(dtype)
    torch.testing.assert_close(h.float(), hr.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(g.float(), gr.float(), rtol=tol, atol=tol)
    assert SW.launches == {"swiglu": 1, "swiglu_backward": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape,causal,window,offs", [
    ((1, 2, 2, 17, 17, 32), True, None, None),
    ((2, 4, 2, 100, 100, 128), True, 13, None),
    ((1, 8, 1, 128, 128, 64), False, None, None),
    ((3, 4, 2, 130, 130, 128), True, None, (0, 7, 129)),
    ((2, 2, 1, 70, 70, 256), True, 9, (64, 0)),
])
def test_cuda_flash_attention_matches_plain(shape, causal, window, offs,
                                            dtype):
    gen = _on_card()
    B, H, KV, T, S, hd = shape
    q = torch.randn(B, H, T, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, KV, S, hd, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    off = None if offs is None else torch.tensor(offs, device="cuda")
    FA.reset_launches()
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    kv_offsets=off, return_lse=True)
    orf, lr = tref.attention_ref(q, k, v, causal=causal, window=window,
                                 kv_offsets=off, return_lse=True)
    tol = _bf16_tol(dtype)
    torch.testing.assert_close(o.float(), orf.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lr, rtol=1e-4, atol=1e-4)
    assert FA.launches == {"flash_attention": 1, "flash_attention_rope": 0,
                           "flash_attention_backward": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("B,H,KV,S,hd,window,ring,offs,theta", [
    (2, 4, 4, 257, 64, None, False, None, None),
    (2, 8, 2, 333, 64, 48, False, None, 1e4),
    (2, 4, 2, 16, 64, 16, True, (0, 3), 1e6),
    (3, 16, 8, 544, 128, None, False, (0, 5, 63), 1e6),
    (2, 8, 1, 40, 32, None, False, None, None),
    (1, 2, 1, 30, 256, 7, False, None, 1e4),
])
def test_cuda_flash_decode_matches_plain(B, H, KV, S, hd, window, ring, offs,
                                         theta, dtype):
    gen = _on_card()
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, KV, S, hd, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    off = None if offs is None else torch.tensor(offs, device="cuda",
                                                 dtype=torch.int32)
    lo = 0 if offs is None else max(offs)
    per_row = torch.arange(B, device="cuda", dtype=torch.int32) + S // 2 + lo
    tol = _bf16_tol(dtype)
    FD.reset_launches()
    positions = [lo, S - 1, S + 7 if ring else S - 1, per_row]
    for pos in positions:
        got = FD.flash_decode(q, k, v, pos, window=window, ring=ring,
                              offsets=off, rope_theta=theta)
        want = tref.flash_decode_ref(q, k, v, pos, window=window, ring=ring,
                                     offsets=off, rope_theta=theta)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    assert FD.launches == {"flash_decode": len(positions),
                           "flash_decode_paged": 0}


@pytest.mark.gpu
def test_cuda_serving_wrappers_reject_what_the_kernels_do_not_take():
    _on_card()
    x = torch.randn(4, 64, device="cuda")
    w = torch.randn(64, 32, device="cuda")
    with pytest.raises(TypeError):
        FN.rmsnorm_residual(x.double(), x.double(), torch.ones(64,
                                                               device="cuda"))
    with pytest.raises(ValueError):
        FN.rmsnorm_residual(x.t(), x.t(), torch.ones(4, device="cuda"))
    with pytest.raises(ValueError):
        big = torch.randn(2, FN.MAX_D + 8, device="cuda")
        FN.rmsnorm_residual(big, big, torch.ones(FN.MAX_D + 8, device="cuda"))
    with pytest.raises(TypeError):
        SW.swiglu(x, w.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError):
        SW.swiglu(x, w.cpu(), w.cpu())
    q = torch.randn(1, 4, 8, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.randn(1, 4, 8, 64, device="cuda")
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, q[:, :3], q[:, :3])
    kv = torch.randn(1, 1, 16, 128, device="cuda")
    with pytest.raises(ValueError, match="group"):
        FD.flash_decode(torch.randn(1, 16, 128, device="cuda"), kv, kv, 3)
    with pytest.raises(ValueError):
        FD.flash_decode(torch.randn(1, 2, 128, device="cuda"), kv, kv,
                        torch.tensor([3, 4], device="cuda"))
    off16 = torch.randn(kv.numel() + 1, device="cuda")[1:].view(kv.shape)
    with pytest.raises(ValueError, match="aligned"):
        FD.flash_decode(torch.randn(1, 2, 128, device="cuda"), off16,
                        off16, 3)


@pytest.mark.gpu
def test_cuda_generate_matches_cpu():
    """Reduced qwen3 in f32, the same parameters on both devices: greedy
    tokens equal, first-step logits within 1e-4, and the kernels launched
    once per layer per step (the norm kernel twice, and once more for the
    final norm)."""
    _on_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate
    cfg = dataclasses.replace(get_config("qwen3-1.7b-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(0, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (3, 20))
    lens = (20, 9, 4)
    for m in (FA, FD, FN, SW):
        m.reset_launches()
    out_gpu = generate(p_gpu, cfg, prompts, max_new_tokens=6,
                       prompt_lens=lens)
    out_cpu = generate(p_cpu, cfg, prompts, max_new_tokens=6,
                       prompt_lens=lens, device="cpu")
    assert torch.equal(out_gpu.cpu(), out_cpu)
    layers = cfg.n_layers
    assert FA.launches["flash_attention"] == layers
    assert FD.launches["flash_decode"] == layers * 5
    assert FN.launches["rmsnorm_residual"] == (2 * layers + 1) * 6
    assert SW.launches["swiglu"] == layers * 6
    logits = []
    for p, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        cache = TT.init_cache(cfg, 3, 21, device=dev)
        lg, _ = TT.prefill_forward(p, cfg, torch.as_tensor(prompts,
                                                           device=dev), cache)
        logits.append(lg.cpu())
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)


def _paged_from_contiguous(k, v, ps, seed=0):
    """A contiguous (B, KV, S, hd) cache scattered into a page pool with a
    shuffled block table (page 0 kept as the trash page)."""
    B, KV, S, hd = k.shape
    NB = S // ps
    perm = np.random.RandomState(seed).permutation(np.arange(1, 1 + B * NB))
    pt = torch.tensor(perm.reshape(B, NB), dtype=torch.int32,
                      device=k.device)

    def pool(x):
        blocks = x.reshape(B, KV, NB, ps, hd).transpose(1, 2)
        p = torch.zeros((1 + B * NB, KV, ps, hd), dtype=x.dtype,
                        device=x.device)
        p[pt.reshape(-1).long()] = blocks.reshape(B * NB, KV, ps, hd)
        return p

    return pool(k), pool(v), pt


PAGED_CASES = [   # B, H, KV, NB, ps, hd, window, offsets, rope_theta
    (2, 4, 4, 4, 16, 64, None, None, None),        # MHA
    (2, 4, 2, 4, 16, 64, None, None, None),        # GQA
    (2, 8, 2, 4, 16, 64, 24, None, None),          # window over pages
    (3, 4, 1, 2, 32, 32, None, (0, 5, 40), None),  # ragged left padding
    (3, 16, 8, 9, 16, 128, None, (0, 3, 17), 1e6),  # qwen3 heads, RoPE
    (2, 4, 2, 5, 7, 256, 9, None, 1e4),            # odd page, window, RoPE
    (16, 16, 8, 64, 16, 128, None, None, 1e6),     # the engine's full width
]


def _paged_inputs(B, H, KV, NB, ps, hd, offs, dtype, gen):
    S = NB * ps
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, KV, S, hd, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    off = None if offs is None else torch.tensor(offs, device="cuda",
                                                 dtype=torch.int32)
    lo = 0 if offs is None else max(offs)
    pos = torch.tensor([max(lo, S - 1 - 7 * i) for i in range(B)],
                       device="cuda", dtype=torch.int32)
    return q, k, v, off, pos


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("B,H,KV,NB,ps,hd,window,offs,theta", PAGED_CASES)
def test_cuda_flash_decode_paged_matches_plain(B, H, KV, NB, ps, hd, window,
                                               offs, theta, dtype, int8):
    """The paged kernel against its plain version, shuffled block table,
    per-row and scalar positions; an int8 pool dequantizes in f32 in both
    (f32 1e-4, bf16 2e-2)."""
    gen = _on_card()
    q, k, v, off, pos = _paged_inputs(B, H, KV, NB, ps, hd, offs, dtype, gen)
    kp, vp, pt = _paged_from_contiguous(k, v, ps)
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = tref.quantize_slots(kp), tref.quantize_slots(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    FD.reset_launches()
    tol = _bf16_tol(dtype)
    for p in (pos, int(pos.min())):
        got = FD.flash_decode_paged(q, kp, vp, pt, p, window=window,
                                    offsets=off, rope_theta=theta, **scales)
        want = tref.flash_decode_paged_ref(q, kp, vp, pt, p, window=window,
                                           offsets=off, rope_theta=theta,
                                           **scales)
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    assert FD.launches == {"flash_decode": 0, "flash_decode_paged": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("B,H,KV,NB,ps,hd,window,offs,theta", PAGED_CASES)
def test_cuda_flash_decode_paged_bit_equals_contiguous(B, H, KV, NB, ps, hd,
                                                       window, offs, theta,
                                                       dtype):
    """On the same cache contents the paged kernel walks the slots as the
    contiguous one does: equal bit for bit."""
    gen = _on_card()
    q, k, v, off, pos = _paged_inputs(B, H, KV, NB, ps, hd, offs, dtype, gen)
    kp, vp, pt = _paged_from_contiguous(k, v, ps, seed=B + NB)
    got = FD.flash_decode_paged(q, kp, vp, pt, pos, window=window,
                                offsets=off, rope_theta=theta)
    want = FD.flash_decode(q, k, v, pos, window=window, offsets=off,
                           rope_theta=theta)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_flash_decode_paged_trash_pages():
    """Table entries past pos on the trash page change nothing; an
    all-trash row is finite, and a row that sees no slot is the mean of V
    over its logical slots, as the plain version."""
    gen = _on_card()
    q, k, v, _, _ = _paged_inputs(2, 4, 2, 4, 16, 64, None, torch.float32,
                                  gen)
    kp, vp, pt = _paged_from_contiguous(k, v, 16)
    pos = torch.tensor([19, 31], device="cuda", dtype=torch.int32)
    full = FD.flash_decode_paged(q, kp, vp, pt, pos)
    trashed = pt.clone()
    trashed[:, 2:] = 0
    assert torch.equal(FD.flash_decode_paged(q, kp, vp, trashed, pos), full)
    dead = FD.flash_decode_paged(q, kp, vp, torch.zeros_like(pt), pos)
    torch.testing.assert_close(
        dead, tref.flash_decode_paged_ref(q, kp, vp, torch.zeros_like(pt),
                                          pos), rtol=1e-4, atol=1e-4)
    off = torch.tensor([25, 0], device="cuda", dtype=torch.int32)
    none = FD.flash_decode_paged(q, kp, vp, pt, pos, offsets=off)
    assert torch.isfinite(dead).all()
    torch.testing.assert_close(
        none, tref.flash_decode_paged_ref(q, kp, vp, pt, pos, offsets=off),
        rtol=1e-4, atol=1e-4)
    assert torch.equal(none, FD.flash_decode(q, k, v, pos, offsets=off))


@pytest.mark.gpu
def test_cuda_flash_decode_paged_rejects_what_the_kernel_does_not_take():
    gen = _on_card()
    q, k, v, _, pos = _paged_inputs(2, 4, 2, 2, 16, 64, None, torch.float32,
                                    gen)
    kp, vp, pt = _paged_from_contiguous(k, v, 16)
    (kq, ks), (vq, vs) = tref.quantize_slots(kp), tref.quantize_slots(vp)
    bad = [
        (TypeError, lambda: FD.flash_decode_paged(q, kp, vp, pt.long(), pos)),
        (ValueError, lambda: FD.flash_decode_paged(q, kp, vp, pt.t(), pos)),
        (TypeError, lambda: FD.flash_decode_paged(q, kp.bfloat16(),
                                                  vp.bfloat16(), pt, pos)),
        (ValueError, lambda: FD.flash_decode_paged(q, kq, vq, pt, pos)),
        (ValueError, lambda: FD.flash_decode_paged(q, kp, vp, pt, pos,
                                                   k_scale=ks, v_scale=vs)),
        (ValueError, lambda: FD.flash_decode_paged(q, kq, vq, pt, pos,
                                                   k_scale=ks)),
        (TypeError, lambda: FD.flash_decode_paged(q, kq, vq, pt, pos,
                                                  k_scale=ks.double(),
                                                  v_scale=vs.double())),
        (TypeError, lambda: FD.flash_decode_paged(q.double(), kp.double(),
                                                  vp.double(), pt, pos)),
        (ValueError, lambda: FD.flash_decode_paged(q, kp, vp, pt.cpu(), pos)),
        (ValueError, lambda: FD.flash_decode_paged(
            torch.randn(2, 4, 48, device="cuda"), kp[..., :48].contiguous(),
            vp[..., :48].contiguous(), pt, pos)),
        (ValueError, lambda: FD.flash_decode_paged(
            q, *(torch.randn(x.numel() + 1, device="cuda")[1:]
                 .view(x.shape) for x in (kp, vp)), pt, pos)),
    ]
    FD.reset_launches()
    for err, call in bad:
        with pytest.raises(err):
            call()
    assert FD.launches["flash_decode_paged"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("hd,itemsize,slots", [
    (32, 2, 64), (64, 2, 64), (128, 2, 32), (256, 2, 16), (32, 4, 64),
    (128, 4, 16), (256, 4, 8), (128, 1, 64), (256, 1, 32), (112, 2, 32),
    (120, 2, 32), (120, 4, 16), (120, 1, 64)])
def test_cuda_chunk_slots_follow_width_and_element_size_only(hd, itemsize,
                                                             slots):
    """The kernels' chunk (which the edge tests and chip_smoke take their
    positions from): 64 slots, fewer where 64 keys would pass 8 KB, a
    power of two."""
    _on_card()
    assert FD.chunk_slots(hd, itemsize) == slots
    assert slots * hd * itemsize <= 8192 or slots == 64
    assert slots & (slots - 1) == 0
    with pytest.raises(ValueError):
        FD.chunk_slots(48, itemsize)


# The pool types of the paged kernel: (q dtype, pool dtype or "int8").
POOL_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, "int8"), (torch.bfloat16, "int8")]


def _pool(kp, vp, pool):
    """(kp, vp, scales) of one pool type from a pool of q's dtype."""
    if pool != "int8":
        return kp, vp, {}
    (kq, ks), (vq, vs) = tref.quantize_slots(kp), tref.quantize_slots(vp)
    return kq, vq, dict(k_scale=ks, v_scale=vs)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 112, 120, 128, 256])
@pytest.mark.parametrize("qdt,pool", POOL_TYPES)
def test_cuda_flash_decode_chunk_boundaries_match_plain(qdt, pool, hd):
    """Rows at positions CHUNK - 1, CHUNK, CHUNK + 1 and 2 CHUNK (the
    kernels' chunk of csrc/flash_decode.cuh), with and without ragged
    offsets, a window and RoPE: both kernels against their plain versions
    (f32 1e-4, bf16 2e-2), and the paged kernel bit-equal to the contiguous
    one on a pool of q's dtype."""
    gen = _on_card()
    itemsize = 1 if pool == "int8" else torch.finfo(qdt).bits // 8
    n = FD.chunk_slots(hd, itemsize)
    B, H, KV, ps = 4, 8, 2, 16
    NB = -(-(2 * n + 9) // ps)
    q, k, v, _, _ = _paged_inputs(B, H, KV, NB, ps, hd, None, qdt, gen)
    kp, vp, pt = _paged_from_contiguous(k, v, ps, seed=hd)
    kq, vq, scales = _pool(kp, vp, pool)
    pos = torch.tensor([n - 1, n, n + 1, 2 * n], device="cuda",
                       dtype=torch.int32)
    off = torch.tensor([0, n - 1, n, 1], device="cuda", dtype=torch.int32)
    tol = _bf16_tol(qdt)
    for kw in (dict(), dict(offsets=off, rope_theta=1e4), dict(window=n)):
        got = FD.flash_decode_paged(q, kq, vq, pt, pos, **kw, **scales)
        want = tref.flash_decode_paged_ref(q, kq, vq, pt, pos, **kw,
                                           **scales)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if pool == "int8":
            continue
        contiguous = FD.flash_decode(q, k, v, pos, **kw)
        torch.testing.assert_close(
            contiguous.float(),
            tref.flash_decode_ref(q, k, v, pos, **kw).float(), rtol=tol,
            atol=tol)
        assert torch.equal(got, contiguous)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,pool", POOL_TYPES)
def test_cuda_flash_decode_padding_past_pos_gives_equal_bits(qdt, pool):
    """A cache of S = 544 slots and the same contents padded to S = 1024
    (random slots past every row's pos; for the paged kernel, block-table
    entries past pos on the trash page): equal bits."""
    gen = _on_card()
    B, H, KV, hd, ps = 3, 16, 8, 128, 16
    q, k, v, _, _ = _paged_inputs(B, H, KV, 34, ps, hd, None, qdt, gen)
    pad = lambda x: torch.cat([x, torch.randn(  # noqa: E731
        B, KV, 1024 - 544, hd, generator=gen, device="cuda").to(qdt)], 2)
    kl, vl = pad(k), pad(v)
    pos = torch.tensor([543, 64, 400], device="cuda", dtype=torch.int32)
    off = torch.tensor([0, 37, 300], device="cuda", dtype=torch.int32)
    kp, vp, pt = _paged_from_contiguous(k, v, ps, seed=3)
    kq, vq, scales = _pool(kp, vp, pool)
    pt_long = torch.cat([pt, torch.zeros(B, 64 - 34, device="cuda",
                                         dtype=torch.int32)], 1)
    for kw in (dict(), dict(offsets=off, rope_theta=1e6)):
        assert torch.equal(FD.flash_decode_paged(q, kq, vq, pt, pos, **kw,
                                                 **scales),
                           FD.flash_decode_paged(q, kq, vq, pt_long, pos,
                                                 **kw, **scales))
        if pool != "int8":
            assert torch.equal(FD.flash_decode(q, k, v, pos, **kw),
                               FD.flash_decode(q, kl, vl, pos, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 7])
@pytest.mark.parametrize("qdt", SERVING_DTYPES)
def test_cuda_flash_decode_paged_ignores_hidden_scales(qdt, ps):
    """An int8 pool whose scales of the slots a row does not see (before
    its offset, past its pos, outside its window) are NaN gives the bits of
    the same pool with finite ones. Pages of 16 take 16-byte scale copies
    of 4 slots (visible and hidden slots in one copy), pages of 7 a copy a
    slot."""
    gen = _on_card()
    B, H, KV, hd, NB = 3, 8, 2, 64, 12
    q, k, v, _, _ = _paged_inputs(B, H, KV, NB, ps, hd, None, qdt, gen)
    kp, vp, pt = _paged_from_contiguous(k, v, ps, seed=ps)
    kq, vq, scales = _pool(kp, vp, "int8")
    pos = torch.tensor([NB * ps - 3, 41, 70], device="cuda",
                       dtype=torch.int32)
    off = torch.tensor([5, 0, 13], device="cuda", dtype=torch.int32)
    for kw in (dict(offsets=off, rope_theta=1e4), dict(window=22)):
        lo = off if "offsets" in kw else torch.clamp(pos - 21, min=0)
        poisoned = {name: s.clone() for name, s in scales.items()}
        for b in range(B):
            hidden = [t for t in range(NB * ps)
                      if t < int(lo[b]) or t > int(pos[b])]
            for t in hidden:
                page = int(pt[b, t // ps])
                for s in poisoned.values():
                    s[page, :, t % ps] = float("nan")
        want = FD.flash_decode_paged(q, kq, vq, pt, pos, **kw, **scales)
        assert torch.isfinite(want.float()).all()
        assert torch.equal(
            FD.flash_decode_paged(q, kq, vq, pt, pos, **kw, **poisoned), want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("qdt,pool", POOL_TYPES)
def test_cuda_flash_decode_rows_equal_their_solo_runs(qdt, pool, B):
    """Each row of a batch of B at its own depth (ragged offsets, RoPE)
    equals its solo run bit for bit, in both kernels."""
    gen = _on_card()
    H, KV, hd, ps, NB = 16, 8, 128, 16, 40
    q, k, v, _, _ = _paged_inputs(B, H, KV, NB, ps, hd, None, qdt, gen)
    kp, vp, pt = _paged_from_contiguous(k, v, ps, seed=B)
    kq, vq, scales = _pool(kp, vp, pool)
    pos = (torch.arange(B, device="cuda", dtype=torch.int32) * 37 + 60) \
        % (NB * ps)
    off = (torch.arange(B, device="cuda", dtype=torch.int32) * 7) % 50
    off = torch.minimum(off, pos)
    kw = dict(rope_theta=1e6)
    paged = FD.flash_decode_paged(q, kq, vq, pt, pos, offsets=off, **kw,
                                  **scales)
    contiguous = None if pool == "int8" else FD.flash_decode(
        q, k, v, pos, offsets=off, **kw)
    for r in range(B):
        one = slice(r, r + 1)
        assert torch.equal(paged[r], FD.flash_decode_paged(
            q[one], kq, vq, pt[one], pos[one], offsets=off[one], **kw,
            **scales)[0])
        if contiguous is not None:
            assert torch.equal(contiguous[r], FD.flash_decode(
                q[one], k[one], v[one], pos[one], offsets=off[one],
                **kw)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("layout,cache_dtype", [("paged", None),
                                                ("paged", "int8"),
                                                ("head", None)])
def test_cuda_continuous_engine_matches_cpu(layout, cache_dtype):
    """Reduced qwen3 in f32, the same parameters on the card (kernels) and
    the CPU (plain versions), through slot reuse: equal completions; the
    paged kernel launched once per layer per step."""
    _on_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import ContinuousEngine, poisson_trace
    cfg = dataclasses.replace(get_config("qwen3-1.7b-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(0, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    reqs = poisson_trace(cfg, 6, rate=0.8, prompt_len_choices=(5, 16, 23),
                         new_token_choices=(3, 9), seed=1)
    kw = dict(num_slots=3, max_len=32, layout=layout, page_size=8,
              cache_dtype=cache_dtype)
    FD.reset_launches()
    eng = ContinuousEngine(p_gpu, cfg, **kw)
    gpu = {i: c.tokens for i, c in eng.run(reqs).items()}
    launches = dict(FD.launches)
    cpu = {i: c.tokens for i, c in ContinuousEngine(
        p_cpu, cfg, device="cpu", **kw).run(reqs).items()}
    assert gpu == cpu and sorted(gpu) == list(range(6))
    key = "flash_decode_paged" if layout == "paged" else "flash_decode"
    assert launches[key] == cfg.n_layers * eng.steps


# ---------------------------------------------------------------------------
# on the card: the LM training slice (B4, B6, B7, B8 and their Functions)
# ---------------------------------------------------------------------------


def _randn_card(gen, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, generator=gen,
                                device="cuda")).to(dtype)


def _close_sum(got, want, tol):
    """A sum over many rows, formed in another order than the plain
    version's: held to tol relative to its largest entry."""
    assert float((got.float() - want.float()).abs().max()) <= tol * max(
        1.0, float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(17, 128), (4096, 2048), (5, 100),
                                   (300, 7), (64, 3840), (64, 5376),
                                   (64, 8192)])
def test_cuda_rmsnorm_residual_backward_matches_plain(shape, residual, dtype):
    gen = _on_card()
    N, d = shape
    s, dy, ds = (_randn_card(gen, N, d, dtype=dtype) for _ in range(3))
    scale = torch.linspace(0.5, 1.5, d, device="cuda")
    ds = ds if residual else None
    FN.reset_launches()
    dx, dscale = FN.rmsnorm_residual_backward(s, scale, dy, ds)
    rdx, rdscale = tref.rmsnorm_residual_backward_ref(s, scale, dy, ds)
    tol = _bf16_tol(dtype)
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    _close_sum(dscale, rdscale, tol)
    again = FN.rmsnorm_residual_backward(s, scale, dy, ds)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dscale)
    assert FN.launches == {"rmsnorm_residual": 0,
                           "rmsnorm_residual_backward": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("d", [2048, 5376, 8192])
def test_cuda_rmsnorm_rows_equal_their_solo_calls(d, dtype):
    """A row of a 4096-row call equals, bit for bit, the row computed
    alone: B3's y and s, B4's dx (the rows' order depends on d only)."""
    gen = _on_card()
    x, r, dy, ds = (_randn_card(gen, 4096, d, dtype=dtype) for _ in range(4))
    scale = torch.linspace(0.5, 1.5, d, device="cuda")
    y, s = FN.rmsnorm_residual(x, r, scale)
    dx, _ = FN.rmsnorm_residual_backward(s, scale, dy, ds)
    for i in (0, 1, 7, 31, 32, 63, 4095):
        yi, si = FN.rmsnorm_residual(x[i:i + 1], r[i:i + 1], scale)
        assert torch.equal(yi[0], y[i]) and torch.equal(si[0], s[i])
        dxi, _ = FN.rmsnorm_residual_backward(si, scale, dy[i:i + 1],
                                              ds[i:i + 1])
        assert torch.equal(dxi[0], dx[i])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape", SWIGLU_SHAPES)
def test_cuda_swiglu_backward_matches_plain(shape, dtype):
    gen = _on_card()
    N, d, F = shape
    x = _randn_card(gen, N, d, dtype=dtype)
    wg, wu = (_randn_card(gen, d, F, dtype=dtype, scale=d ** -0.5)
              for _ in range(2))
    dh = _randn_card(gen, N, F, dtype=dtype)
    g = tref.swiglu_ref(x, wg, wu)[1]
    SW.reset_launches()
    got = SW.swiglu_backward(x, wg, wu, g, dh)
    want = tref.swiglu_backward_ref(x, wg, wu, g, dh)
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    tol = _bf16_tol(dtype)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    assert SW.launches == {"swiglu": 0, "swiglu_backward": 1}


def _swiglu_inputs(gen, N, d, F, dtype=torch.bfloat16):
    x = _randn_card(gen, N, d, dtype=dtype)
    wg, wu = (_randn_card(gen, d, F, dtype=dtype, scale=d ** -0.5)
              for _ in range(2))
    dh = _randn_card(gen, N, F, dtype=dtype)
    return x, wg, wu, tref.swiglu_ref(x, wg, wu)[1], dh


def _swiglu_pair(x, wg, wu, g, dh):
    """(h, g, dx, dg, du) of the forward and backward kernels."""
    return SW.swiglu(x, wg, wu) + SW.swiglu_backward(x, wg, wu, g, dh)


@pytest.mark.gpu
@pytest.mark.parametrize("d,F", [(2048, 6144), (64, 200), (100, 72)])
@pytest.mark.parametrize("N,rows", [(4096, (0, 1, 127, 128, 2049, 4095)),
                                    (8, tuple(range(8)))])
def test_cuda_swiglu_rows_equal_their_solo_runs(N, rows, d, F):
    """Batch invariance in bf16: a row's h, g, dx, dg and du are bit-equal
    whether the row is computed among N or alone."""
    gen = _on_card()
    ins = _swiglu_inputs(gen, N, d, F)
    x, wg, wu, g, dh = ins
    many = _swiglu_pair(*ins)
    for i in rows:
        one = _swiglu_pair(x[i:i + 1].clone(), wg, wu, g[i:i + 1].clone(),
                           dh[i:i + 1].clone())
        for name, a, b in zip(("h", "g", "dx", "dg", "du"), many, one):
            assert torch.equal(a[i:i + 1], b), (name, i)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape", [(4096, 2048, 6144), (77, 512, 1000)])
def test_cuda_swiglu_pair_repeats_bit_for_bit(shape, dtype):
    gen = _on_card()
    ins = _swiglu_inputs(gen, *shape, dtype=dtype)
    SW.reset_launches()
    first, again = _swiglu_pair(*ins), _swiglu_pair(*ins)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert SW.launches == {"swiglu": 2, "swiglu_backward": 2}


ATTN_TRAIN_CASES = [
    # (B, H, KV, T, hd), causal, window: ragged T (17, 100, 130), a window,
    # non-causal, GQA 2:1, 4:1 and 8:1, hd 32 to 256 (the forward only)
    ((1, 2, 2, 17, 32), True, None),
    ((2, 4, 2, 100, 128), True, 13),
    ((1, 8, 1, 128, 64), False, None),
    ((2, 16, 8, 130, 128), True, None),
    ((1, 8, 2, 100, 64), True, None),
    ((2, 2, 1, 70, 256), True, 9),
    ((2, 4, 1, 100, 120), True, 13),
    ((1, 8, 2, 130, 112), False, None),
]
ATTN_BWD_CASES = [c for c in ATTN_TRAIN_CASES
                  if c[0][-1] in FA.BWD_HEAD_DIMS]


def _attn_inputs(gen, shape, dtype):
    B, H, KV, T, hd = shape
    q, do = (_randn_card(gen, B, H, T, hd, dtype=dtype) for _ in range(2))
    k, v = (_randn_card(gen, B, KV, T, hd, dtype=dtype) for _ in range(2))
    pos = (torch.arange(T, device="cuda")[None]
           + 3 * torch.arange(B, device="cuda")[:, None]).float()
    return q, k, v, pos, do


def _fa_launches(**counts):
    return {"flash_attention": 0, "flash_attention_rope": 0,
            "flash_attention_backward": 0, **counts}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape,causal,window", ATTN_TRAIN_CASES)
def test_cuda_flash_attention_rope_matches_plain(shape, causal, window,
                                                 dtype):
    gen = _on_card()
    q, k, v, pos, _ = _attn_inputs(gen, shape, dtype)
    FA.reset_launches()
    o, lse = FA.flash_attention_rope_fwd(q, k, v, pos, theta=1e4,
                                         causal=causal, window=window,
                                         return_lse=True)
    orf, lr = tref.attention_rope_ref(q, k, v, pos, theta=1e4, causal=causal,
                                      window=window, return_lse=True)
    tol = _bf16_tol(dtype)
    torch.testing.assert_close(o.float(), orf.float(), rtol=tol, atol=tol)
    # f32: 1e-4. bf16: the kernel rotates q and k in f32 and rounds them to
    # bf16 for the tensor cores, while the plain version keeps them in f32,
    # so the logits (and lse) differ by bf16 rounding: BF16_TOL
    torch.testing.assert_close(lse, lr, rtol=tol, atol=tol)
    assert FA.launches == _fa_launches(flash_attention_rope=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape,causal,window", ATTN_BWD_CASES)
def test_cuda_flash_attention_backward_matches_plain(shape, causal, window,
                                                     dtype):
    gen = _on_card()
    q, k, v, _, do = _attn_inputs(gen, shape, dtype)
    o, lse = tref.attention_ref(q, k, v, causal=causal, window=window,
                                return_lse=True)
    FA.reset_launches()
    got = FA.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    want = tref.attention_backward_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    tol = 5e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    again = FA.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert FA.launches == _fa_launches(flash_attention_backward=2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
@pytest.mark.parametrize("shape,causal,window", ATTN_BWD_CASES)
def test_cuda_flash_attention_rope_backward_matches_plain(shape, causal,
                                                          window, dtype,
                                                          monkeypatch):
    """One call on the UNROTATED q, k against the composite plain version
    (q, k rotated, the plain backward, dq, dk rotated back); no plain
    rotation runs around the kernel; two calls give the same bits."""
    gen = _on_card()
    q, k, v, pos, do = _attn_inputs(gen, shape, dtype)
    o, lse = tref.attention_rope_ref(q, k, v, pos, theta=1e4, causal=causal,
                                     window=window, return_lse=True)
    qr, kr = tref.rope_rotate_hm(q, pos, 1e4), tref.rope_rotate_hm(k, pos,
                                                                   1e4)
    dqr, dkr, dvr = tref.attention_backward_ref(qr, kr, v, o, lse, do,
                                                causal=causal, window=window)
    want = (tref.rope_rotate_hm(dqr, -pos, 1e4),
            tref.rope_rotate_hm(dkr, -pos, 1e4), dvr)
    FA.reset_launches()
    calls = []
    real = tref.rope_rotate_hm
    monkeypatch.setattr(tref, "rope_rotate_hm",
                        lambda *a: calls.append(1) or real(*a))
    got = FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                           theta=1e4, causal=causal,
                                           window=window)
    again = FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                             theta=1e4, causal=causal,
                                             window=window)
    tol = 5e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert not calls
    assert FA.launches == _fa_launches(flash_attention_backward=2)


@pytest.mark.gpu
def test_cuda_autograd_functions_match_plain_autograd():
    """Each Function's gradients on the card (kernels forward and backward)
    against torch autograd through the plain forward, f32."""
    gen = _on_card()
    from repro_torch.kernels import ops as tops

    def grads(fn, inputs, cot):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(out, cot)), leaves)

    def check(kern, plain, inputs, cot, tol=1e-4):
        for a, b in zip(grads(kern, inputs, cot), grads(plain, inputs, cot)):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)

    x, r, dy, ds = (_randn_card(gen, 33, 256) for _ in range(4))
    scale = torch.linspace(0.5, 1.5, 256, device="cuda")
    check(lambda a, b, c: tops.rmsnorm_residual(a, b, c),
          lambda a, b, c: tref.rmsnorm_residual_ref(a, b, c),
          (x, r, scale), (dy, ds))
    check(lambda a, c: tops.rmsnorm_residual(a, None, c)[0],
          lambda a, c: tref.rmsnorm_residual_ref(a, None, c)[0],
          (x, scale), (dy,))
    wg, wu = (_randn_card(gen, 256, 384, scale=1 / 16) for _ in range(2))
    check(tops.swiglu, lambda a, b, c: tref.swiglu_ref(a, b, c)[0],
          (x, wg, wu), (_randn_card(gen, 33, 384),))
    q, k, v, pos, do = _attn_inputs(gen, (2, 4, 2, 100, 64), torch.float32)
    model = [t.transpose(1, 2) for t in (q, k, v, do)]
    check(lambda a, b, c: tops.flash_attention_rope(a, b, c, pos, theta=1e4,
                                                    window=13),
          lambda a, b, c: tref.attention_rope_ref(
              a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), pos,
              theta=1e4, window=13).transpose(1, 2),
          model[:3], model[3:], tol=5e-4)
    check(lambda a, b, c: tops.flash_attention_hm(a, b, c),
          lambda a, b, c: tref.attention_ref(a, b, c), (q, k, v), (do,),
          tol=5e-4)


@pytest.mark.gpu
def test_cuda_training_wrappers_reject_what_the_kernels_do_not_take():
    _on_card()
    s = torch.randn(4, 64, device="cuda")
    one = torch.ones(64, device="cuda")
    with pytest.raises(TypeError):
        FN.rmsnorm_residual_backward(s, one, s.bfloat16(), None)
    with pytest.raises(ValueError):
        FN.rmsnorm_residual_backward(s, one, s, s[:2])
    with pytest.raises(ValueError):
        FN.rmsnorm_residual_backward(s.t(), torch.ones(4, device="cuda"),
                                     s.t(), None)
    x = torch.randn(4, 64, device="cuda")
    w = torch.randn(64, 32, device="cuda")
    g = torch.randn(4, 32, device="cuda")
    with pytest.raises(TypeError):
        SW.swiglu_backward(x, w, w, g.bfloat16(), g)
    with pytest.raises(ValueError):
        SW.swiglu_backward(x, w, w, g[:, :16], g)
    # the wgmma body's operands must be 16-byte aligned (TMA base addresses)
    xb = torch.zeros(1 + 4 * 64, device="cuda",
                     dtype=torch.bfloat16)[1:].view(4, 64)
    wb = w.bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        SW.swiglu(xb, wb, wb)
    with pytest.raises(ValueError, match="aligned"):
        SW.swiglu_backward(xb, wb, wb, g.bfloat16(), g.bfloat16())
    q = torch.randn(1, 2, 8, 256, device="cuda")
    lse = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_backward(q, q, q, q, lse, q)
    q = torch.randn(1, 2, 8, 64, device="cuda")
    with pytest.raises(TypeError):
        FA.flash_attention_backward(q, q, q, q, lse.double(), q)
    # bf16 operands, and f32 q, k with RoPE, must be 16-byte aligned: the
    # tensor-core bodies and the rotation pass copy 16-byte chunks
    off = torch.zeros(1 + q.numel(), device="cuda",
                      dtype=torch.bfloat16)[1:].view(q.shape)
    qb = q.bfloat16()
    pos0 = torch.zeros(1, 8, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_backward(off, qb, qb, qb, lse, qb)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_rope_fwd(qb, off, qb, pos0, theta=1e4)
    off32 = torch.zeros(1 + q.numel(), device="cuda")[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_rope_backward(off32, q, q, pos0, q, lse, q,
                                         theta=1e4)
    with pytest.raises(ValueError):
        FA.flash_attention_rope_fwd(q, q[:, :, :4], q[:, :, :4],
                                    torch.zeros(1, 8, device="cuda"),
                                    theta=1e4)
    with pytest.raises(ValueError):
        FA.flash_attention_rope_fwd(q, q, q, torch.zeros(2, 8, device="cuda"),
                                    theta=1e4)


@pytest.mark.gpu
def test_cuda_lm_train_step_has_gradients_on_every_leaf():
    """A kernel-path train step on the card: every leaf's gradient is
    non-zero (the norm1 scales and wq included: they are reached only
    through the autograd Functions), equal to the CPU step's, and the
    step's loss and parameters equal the CPU plain step's (f32)."""
    _on_card()
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_lm_train_step
    cfg = dataclasses.replace(get_config("qwen3-1.7b-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(0, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 48))
    grads = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        leaves = [t.detach().requires_grad_(True) for t in tree.leaves(p)]
        loss, _ = TT.lm_loss(tree.unflatten(p, leaves), cfg,
                             {"tokens": torch.as_tensor(tokens, device=dev)},
                             use_kernels=dev == "cuda")
        grads[dev] = torch.autograd.grad(loss, leaves)
    for name, (a, b) in zip(range(len(grads["cpu"])),
                            zip(grads["cuda"], grads["cpu"])):
        assert float(a.abs().max()) > 0, f"leaf {name} has no gradient"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    body = p_gpu["stack"]["body"][0][0]
    assert set(body) >= {"norm1", "mixer", "norm2", "ff"}
    lb = LargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    reg = Regime(base_lr=0.01, total_steps=4, drop_every=4)
    outs = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        step = make_lm_train_step(cfg, lb, reg, use_kernels=dev == "cuda")
        outs[dev] = step(p, sgd.init(p), {"tokens": torch.as_tensor(
            tokens, device=dev)}, 0)
    torch.testing.assert_close(outs["cuda"][2]["loss"].cpu(),
                               outs["cpu"][2]["loss"], rtol=1e-5, atol=1e-5)
    for a, b in zip(tree.leaves(outs["cuda"][0]), tree.leaves(outs["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the SSM slice on the card (B10, B11)
# ---------------------------------------------------------------------------


def _mamba_card(gen, B, c, di, ds, dtype=torch.float32):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    xc = randn(B, c, di).to(dtype)
    dt = (0.1 * torch.nn.functional.softplus(randn(B, c, di))).to(dtype)
    Bm, Cm = randn(B, c, ds).to(dtype), randn(B, c, ds).to(dtype)
    A = -randn(di, ds).abs()
    h0 = randn(B, di, ds)
    return xc, dt, Bm, Cm, A, h0, randn(B, c, di), randn(B, di, ds)


# shapes whose dA sums 2048 terms a (channel, state)
_MAMBA_LONG_SUMS = [(8, 256, 8192, 16), (1, 2048, 96, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 128, 8), (2, 16, 256, 16),
                                   (2, 32, 512, 16), (2, 13, 128, 8),
                                   (2, 16, 100, 16), (3, 300, 200, 5),
                                   (8, 256, 8192, 16), (1, 256, 8192, 16),
                                   (1, 2048, 96, 16), (2, 40, 200, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba_chunk_matches_plain(shape, dtype):
    """B10 and B11 against their plain versions on the card: f32 at 1e-4,
    bf16 inputs at 2e-2 (the gradients in bf16); two calls of each kernel
    are bit-equal (no atomics). The shapes: the reference tests', d_state 5,
    the falcon-mamba path (8, 256, 8192, 16) and a solo row of it, a chunk
    of 2048 steps (its checkpoints in the device scratch) and d_inner off a
    block's channels (100, 200)."""
    gen = _on_card()
    *ins, dy, dhl = _mamba_card(gen, *shape, dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    MS.reset_launches()
    y = MS.mamba_chunk(*ins)
    for a, b in zip(y, tref.mamba_chunk_ref(*ins)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    got = MS.mamba_chunk_backward(*ins, dy, dhl)
    want = tref.mamba_chunk_backward_ref(*ins, dy, dhl)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if i == 4 and shape in _MAMBA_LONG_SUMS:
            # dA sums B x c terms in another order than the plain version:
            # held to tol relative to its largest entry, as chip_smoke
            scale = max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= tol * scale
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol)
    assert all(torch.equal(a, b) for a, b in zip(MS.mamba_chunk(*ins), y))
    again = MS.mamba_chunk_backward(*ins, dy, dhl)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert MS.launches == {"mamba_chunk": 2, "mamba_chunk_backward": 2}


# the shapes of tests/test_torch_mamba_plan.py:PLAN_SHAPES
_MAMBA_PLAN_SHAPES = [(1, 8, 128, 8), (2, 16, 256, 16), (2, 32, 512, 16),
                      (2, 13, 128, 8), (2, 16, 100, 16), (8, 256, 8192, 16),
                      (1, 256, 8192, 16), (2, 256, 100, 16),
                      (2, 256, 8200, 16), (3, 40, 200, 5), (2, 64, 8200, 8),
                      (1, 7, 64, 16)]
_SMEM_PER_BLOCK = 232448       # the most one H100 block may take


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", _MAMBA_PLAN_SHAPES)
def test_cuda_mamba_plan_is_the_models_and_covers_every_state_once(
        shape, backward):
    """The built library's launch is the one tests/_mamba_plan_model.py
    models (on which the CPU model of the kernels' order runs): every
    (row, channel, state) owned by one thread; a row alone gets the launch
    of its batch, so the same order of sums."""
    _on_card()
    B, c, di, ds = shape
    p = MS.plan(*shape, backward=backward)
    m = model_plan(*shape, backward)
    assert p.backward == backward
    assert (p.DS, p.q, p.lanes, p.threads, p.channels, p.grid, p.steps,
            p.nseg) == (m.DS, m.q, m.lanes, m.threads, m.channels, m.grid,
                        m.steps, m.nseg)
    assert (owners(p, di, ds) == 1).all()
    one = MS.plan(1, c, di, ds, backward=backward)
    assert dataclasses.replace(one, grid=p.grid) == p


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds", [5, 8, 16])
@pytest.mark.parametrize("c", [13, 256, 2048])
def test_cuda_mamba_smem_within_budget_and_checkpoints_in_scratch_past_it(
        c, ds, dtype):
    """Each block's shared memory within the card's 227 KB; the backward's
    checkpoints (a thread's q states at each segment's start) in shared
    memory exactly when the block then fits the budget of its share of an
    SM, else in the device scratch."""
    _on_card()
    budget = MS.built_constants()["kSmemBudget"]
    assert budget <= _SMEM_PER_BLOCK
    pf = MS.plan(2, c, 8192, ds, backward=False, dtype=dtype)
    assert pf.smem_bytes <= _SMEM_PER_BLOCK and pf.ckpt == ""
    pb = MS.plan(2, c, 8192, ds, backward=True, dtype=dtype)
    assert pb.smem_bytes <= budget
    ckpt_bytes = pb.nseg * pb.threads * pb.q * 4
    if pb.ckpt != "smem":
        assert pb.ckpt == "scratch" and pb.smem_bytes + ckpt_bytes > budget
    assert MS.plan(8, 16, 8192, 16, backward=True).ckpt == "smem"
    assert MS.plan(1, 2048, 96, 16, backward=True).ckpt == "scratch"


@pytest.mark.gpu
def test_cuda_mamba_padding_is_exact_and_chunks_chain():
    """dt = 0 steps leave the state bit for bit (a left-padded row equals
    its unpadded run); two chained chunks equal one scan; the autograd
    Function's gradients equal plain autograd through the plain forward."""
    gen = _on_card()
    xc, dt, Bm, Cm, A, h0, dy, dhl = _mamba_card(gen, 2, 64, 256, 16)
    dt[:, :23] = 0
    y, h = MS.mamba_chunk(xc, dt, Bm, Cm, A, h0)
    ys, hs = MS.mamba_chunk(*(t[:, 23:].contiguous() for t in
                              (xc, dt, Bm, Cm)), A, h0)
    assert torch.equal(h, hs) and torch.equal(y[:, 23:], ys)
    y1, h1 = MS.mamba_chunk(*(t[:, :40].contiguous() for t in
                              (xc, dt, Bm, Cm)), A, h0)
    y2, h2 = MS.mamba_chunk(*(t[:, 40:].contiguous() for t in
                              (xc, dt, Bm, Cm)), A, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(h2, h, rtol=1e-4, atol=1e-4)
    from repro_torch.kernels import ops as tops
    ins = (xc, dt, Bm, Cm, A, h0)
    grads = []
    for fn in (tops.mamba_chunk, tref.mamba_chunk_ref):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        yy, hh = fn(*leaves)
        grads.append(torch.autograd.grad((yy * dy).sum() + (hh * dhl).sum(),
                                         leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_mamba_wrappers_reject_what_the_kernels_do_not_take():
    gen = _on_card()
    xc, dt, Bm, Cm, A, h0, dy, dhl = _mamba_card(gen, 2, 8, 64, 8)
    with pytest.raises(TypeError):
        MS.mamba_chunk(xc, dt.bfloat16(), Bm, Cm, A, h0)
    with pytest.raises(TypeError):
        MS.mamba_chunk(xc, dt, Bm, Cm, A, h0.bfloat16())
    with pytest.raises(ValueError):
        MS.mamba_chunk(xc, dt, Bm, Cm, A, h0.transpose(1, 2))
    with pytest.raises(TypeError):
        MS.mamba_chunk_backward(xc, dt, Bm, Cm, A, h0, dy.bfloat16(), dhl)
    big = torch.zeros(2, 8, 17, device="cuda")
    with pytest.raises(ValueError, match="d_state"):
        MS.mamba_chunk(xc, dt, big, big, torch.zeros(64, 17, device="cuda"),
                       torch.zeros(2, 64, 17, device="cuda"))
    long = MS.MAX_BWD_CHUNK + 1
    x2 = torch.zeros(1, long, 8, device="cuda")
    b2 = torch.zeros(1, long, 4, device="cuda")
    with pytest.raises(ValueError, match="chunk"):
        MS.mamba_chunk_backward(x2, x2, b2, b2,
                                torch.zeros(8, 4, device="cuda"),
                                torch.zeros(1, 8, 4, device="cuda"), x2,
                                torch.zeros(1, 8, 4, device="cuda"))


@pytest.mark.gpu
def test_cuda_falcon_mamba_matches_cpu():
    """Reduced falcon-mamba in f32, the same parameters on both devices:
    greedy ragged tokens equal with one B10 launch a layer (none in
    decode), and one train step's loss (1e-5) and parameters (1e-4)."""
    _on_card()
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.serving import generate
    from repro_torch.train.trainer import make_lm_train_step
    cfg = dataclasses.replace(get_config("falcon-mamba-7b-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(0, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (3, 20))
    lens = (20, 9, 4)
    MS.reset_launches()
    out_gpu = generate(p_gpu, cfg, prompts, max_new_tokens=6,
                       prompt_lens=lens)
    out_cpu = generate(p_cpu, cfg, prompts, max_new_tokens=6,
                       prompt_lens=lens, device="cpu")
    assert torch.equal(out_gpu.cpu(), out_cpu)
    assert MS.launches == {"mamba_chunk": cfg.n_layers,
                           "mamba_chunk_backward": 0}
    lb = LargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    reg = Regime(base_lr=0.01, total_steps=4, drop_every=4)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 48))
    outs = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        step = make_lm_train_step(cfg, lb, reg, use_kernels=dev == "cuda")
        outs[dev] = step(p, sgd.init(p), {"tokens": torch.as_tensor(
            tokens, device=dev)}, 0)
    torch.testing.assert_close(outs["cuda"][2]["loss"].cpu(),
                               outs["cpu"][2]["loss"], rtol=1e-5, atol=1e-5)
    for a, b in zip(tree.leaves(outs["cuda"][0]), tree.leaves(outs["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
