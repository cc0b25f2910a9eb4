"""The LM training slice's kernels held to the JAX package on the CPU, in
f32: each port wrapper (which takes its plain version for a CPU tensor)
against the Pallas kernel in interpret mode and its ``repro.kernels.ref``
oracle, at the reference tests' tolerances (tests/test_fused_kernels.py,
tests/test_kernels.py): the norm backward 1e-5, the SwiGLU backward 1e-4,
the RoPE flash forward (o and lse) 2e-5, the flash backward 5e-4; and each
autograd Function's gradients against the oracle VJP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels import ref as jref
from repro.kernels.flash_attention import (flash_attention_backward_pallas,
                                           flash_attention_pallas,
                                           flash_attention_rope_backward_pallas,
                                           flash_attention_rope_pallas)
from repro.kernels.fused_norm import rmsnorm_residual_backward_pallas
from repro.kernels.swiglu import swiglu_backward_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swiglu as SW


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# B4: rmsnorm_residual backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(17, 128), (33, 256), (5, 512), (3, 100)])
def test_rmsnorm_residual_backward_matches_reference(shape):
    N, d = shape
    rng = np.random.RandomState(N + d)
    x, r, dy, ds = (_randn(rng, N, d) for _ in range(4))
    scale = np.linspace(0.5, 1.5, d, dtype=np.float32)
    s = x + r
    dx, dscale = FN.rmsnorm_residual_backward(*_t(s, scale, dy, ds))
    dxr, drr, dscr = jref.rmsnorm_residual_vjp_ref(x, r, scale, (dy, ds))
    for got, want in zip(tref.rmsnorm_residual_vjp_ref(
            *_t(x, r, scale), _t(dy, ds)), (dxr, drr, dscr)):
        _close(got, want, 1e-5)
    _close(dx, dxr, 1e-5)
    _close(dx, drr, 1e-5)
    _close(dscale, dscr, 1e-5)
    if d % 128 == 0:                 # the Pallas kernel's lane gate
        dxk, dsck = rmsnorm_residual_backward_pallas(s, scale, dy, ds,
                                                     interpret=True)
        _close(dx, dxk, 1e-5)
        _close(dscale, dsck, 1e-5)
    # the autograd Function: gradients w.r.t. x, r and scale
    xt, rt, st = (torch.tensor(a, requires_grad=True) for a in (x, r, scale))
    y, s_out = tops.rmsnorm_residual(xt, rt, st)
    gx, gr, gs = torch.autograd.grad(
        (y * torch.tensor(dy)).sum() + (s_out * torch.tensor(ds)).sum(),
        (xt, rt, st))
    for got, want in ((gx, dxr), (gr, drr), (gs, dscr)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("shape", [(17, 128), (5, 512), (3, 100)])
def test_rmsnorm_without_residual_backward_matches_reference(shape):
    """``r=None`` (the width norms): a null cotangent on s; the gradient of
    y alone equals the JAX VJP of ``rmsnorm_apply``, and s is x itself."""
    N, d = shape
    rng = np.random.RandomState(3 * N + d)
    x, dy = _randn(rng, N, d), _randn(rng, N, d)
    scale = np.linspace(0.5, 1.5, d, dtype=np.float32)
    _, vjp = jax.vjp(lambda a, c: jlayers.rmsnorm_apply({"scale": c}, a),
                     jnp.asarray(x), jnp.asarray(scale))
    want_dx, want_dscale = vjp(jnp.asarray(dy))
    dx, dscale = FN.rmsnorm_residual_backward(*_t(x, scale, dy), None)
    vdx, vdr, vdscale = tref.rmsnorm_residual_vjp_ref(
        *_t(x), None, *_t(scale), (torch.tensor(dy), None))
    assert vdr is None
    _close(vdx, want_dx, 1e-5)
    _close(vdscale, want_dscale, 1e-5)
    _close(dx, want_dx, 1e-5)
    _close(dscale, want_dscale, 1e-5)
    xt, st = (torch.tensor(a, requires_grad=True) for a in (x, scale))
    y, s = tops.rmsnorm_residual(xt, None, st)
    assert s is xt
    gx, gs = torch.autograd.grad((y * torch.tensor(dy)).sum(), (xt, st))
    _close(gx, want_dx, 1e-5)
    _close(gs, want_dscale, 1e-5)


def test_rmsnorm_residual_unused_s_cotangent_is_null(monkeypatch):
    """When only y reaches the loss, the backward gets ``ds=None``."""
    seen = []
    real = FN.rmsnorm_residual_backward

    def spy(s, scale, dy, ds, **kw):
        seen.append(ds)
        return real(s, scale, dy, ds, **kw)

    monkeypatch.setattr(FN, "rmsnorm_residual_backward", spy)
    rng = np.random.RandomState(0)
    x, r = (torch.tensor(_randn(rng, 4, 128), requires_grad=True)
            for _ in range(2))
    y, _ = tops.rmsnorm_residual(x, r, torch.ones(128))
    y.sum().backward()
    assert seen == [None]


# ---------------------------------------------------------------------------
# B6: swiglu backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(17, 128, 256), (33, 256, 384),
                                   (5, 100, 60)])
def test_swiglu_backward_matches_reference(shape):
    N, d, F = shape
    rng = np.random.RandomState(N + d + F)
    x = _randn(rng, N, d)
    wg, wu = _randn(rng, d, F, scale=d ** -0.5), _randn(rng, d, F,
                                                         scale=d ** -0.5)
    dh = _randn(rng, N, F)
    g = np.asarray(jref.swiglu_ref(x, wg, wu)[1])
    dx, dg, du = SW.swiglu_backward(*_t(x, wg, wu, g, dh))
    if d % 128 == 0 and F % 128 == 0:
        dxk, dgk, duk = swiglu_backward_pallas(x, wg, wu, g, dh,
                                               interpret=True)
        for got, want in ((dx, dxk), (dg, dgk), (du, duk)):
            _close(got, want, 1e-4)
    dxr, dwgr, dwur = jref.swiglu_vjp_ref(x, wg, wu, dh)
    for got, want in zip(tref.swiglu_vjp_ref(*_t(x, wg, wu, dh)),
                         (dxr, dwgr, dwur)):
        _close(got, want, 1e-4)
    _close(dx, dxr, 1e-4)
    xt, wgt, wut = (torch.tensor(a, requires_grad=True) for a in (x, wg, wu))
    h = tops.swiglu(xt, wgt, wut)
    grads = torch.autograd.grad((h * torch.tensor(dh)).sum(), (xt, wgt, wut))
    for got, want in zip(grads, (dxr, dwgr, dwur)):
        _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# B7 / B8: RoPE flash attention forward, flash backward
# ---------------------------------------------------------------------------

# (B, H, KV, T, hd): MHA, GQA, ragged T
ROPE_SHAPES = [(1, 2, 2, 17, 32), (2, 4, 2, 64, 64), (1, 4, 2, 100, 32)]


def _rope_inputs(shape, seed):
    B, H, KV, T, hd = shape
    rng = np.random.RandomState(seed)
    q, do = _randn(rng, B, H, T, hd), _randn(rng, B, H, T, hd)
    k, v = _randn(rng, B, KV, T, hd), _randn(rng, B, KV, T, hd)
    # staggered per-row positions (continuations, not only 0..T-1)
    pos = (np.arange(T)[None] + 3 * np.arange(B)[:, None]).astype(np.float32)
    return q, k, v, pos, do


@pytest.mark.parametrize("shape", ROPE_SHAPES)
@pytest.mark.parametrize("window", [None, 13])
def test_flash_attention_rope_matches_reference(shape, window):
    q, k, v, pos, _ = _rope_inputs(shape, sum(shape))
    o, lse = FA.flash_attention_rope_fwd(*_t(q, k, v, pos), theta=1e4,
                                         window=window, return_lse=True)
    ok, lk = flash_attention_rope_pallas(q, k, v, pos, theta=1e4,
                                         causal=True, window=window,
                                         block_q=32, block_k=32,
                                         return_residuals=True,
                                         interpret=True)
    _close(o, ok, 2e-5)
    _close(lse, lk, 2e-5)
    _close(o, jref.attention_rope_ref(q, k, v, pos, theta=1e4, causal=True,
                                      window=window), 2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 13),
                                           (False, None)])
@pytest.mark.parametrize("shape", [(1, 2, 2, 17, 32), (2, 4, 2, 64, 32)])
def test_flash_attention_backward_matches_reference(shape, causal, window):
    B, H, KV, T, hd = shape
    q, k, v, _, do = _rope_inputs(shape, 29 + T)
    o, lse = flash_attention_pallas(q, k, v, causal=causal, window=window,
                                    block_q=32, block_k=32,
                                    return_residuals=True, interpret=True)
    got = FA.flash_attention_backward(*_t(q, k, v, o, lse, do),
                                      causal=causal, window=window)
    kern = flash_attention_backward_pallas(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           block_q=32, block_k=32,
                                           fuse_dq=False, interpret=True)
    want = jref.attention_vjp_ref(q, k, v, do, causal=causal, window=window)
    oracle = tref.attention_vjp_ref(*_t(q, k, v, do), causal=causal,
                                    window=window)
    for g, kk, w, o_ in zip(got, kern, want, oracle):
        _close(g, kk, 5e-4)
        _close(g, w, 5e-4)
        _close(o_, w, 5e-4)
    # the differentiable head-major op (forward and backward in the port)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tops.flash_attention_hm(qt, kt, vt, causal=causal, window=window)
    _close(out, jref.attention_ref(q, k, v, causal=causal, window=window),
           2e-5)
    grads = torch.autograd.grad((out * torch.tensor(do)).sum(), (qt, kt, vt))
    for g, w in zip(grads, want):
        _close(g, w, 5e-4)


@pytest.mark.parametrize("shape", ROPE_SHAPES)
@pytest.mark.parametrize("window", [None, 13])
def test_flash_attention_rope_backward_matches_reference(shape, window):
    q, k, v, pos, do = _rope_inputs(shape, 5 + sum(shape))
    o, lse = flash_attention_rope_pallas(q, k, v, pos, theta=1e4,
                                         causal=True, window=window,
                                         block_q=32, block_k=32,
                                         return_residuals=True,
                                         interpret=True)
    got = FA.flash_attention_rope_backward(*_t(q, k, v, pos, o, lse, do),
                                           theta=1e4, window=window)
    kern = flash_attention_rope_backward_pallas(
        q, k, v, pos, o, lse, do, theta=1e4, causal=True, window=window,
        block_q=32, block_k=32, interpret=True)
    want = jref.attention_rope_vjp_ref(q, k, v, pos, do, theta=1e4,
                                       causal=True, window=window)
    oracle = tref.attention_rope_vjp_ref(*_t(q, k, v, pos, do), theta=1e4,
                                         window=window)
    for g, kk, w, o_ in zip(got, kern, want, oracle):
        _close(g, kk, 5e-4)
        _close(g, w, 5e-4)
        _close(o_, w, 5e-4)
    # the model-layout op (B, T, H, hd), as attention_full calls it
    qt, kt, vt = (torch.tensor(a.transpose(0, 2, 1, 3), requires_grad=True)
                  for a in (q, k, v))
    out = tops.flash_attention_rope(qt, kt, vt, torch.tensor(pos), theta=1e4,
                                    window=window)
    grads = torch.autograd.grad(
        (out * torch.tensor(do.transpose(0, 2, 1, 3))).sum(), (qt, kt, vt))
    for g, w in zip(grads, want):
        _close(g.transpose(1, 2), w, 5e-4)
