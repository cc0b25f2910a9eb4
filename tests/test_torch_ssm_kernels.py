"""The SSM slice's kernels held to the JAX package on the CPU: the plain
versions of the Mamba chunk scan forward (B10) and backward (B11), which
each port wrapper takes for a CPU tensor, against
``mamba_chunk_pallas``/``mamba_chunk_backward_pallas`` in interpret mode
and the ``repro.kernels.ref`` oracles, at the shapes of
tests/test_kernels.py plus a ragged chunk (c=13) and a d_inner that is not
a multiple of 128 (100). f32 at 1e-4, the reference's tolerance; bf16
inputs (xc, dt, Bm, Cm) at 1e-1, as tests/test_kernels.py holds its bf16
gradients. Then ``_MambaChunk``'s gradients against ``jax.grad`` through
``repro.kernels.ops.mamba_chunk``, chaining across chunks, and the
wrappers' limits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import (mamba_chunk_backward_pallas,
                                      mamba_chunk_pallas)
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops as tops

SHAPES = [(1, 8, 128, 8), (2, 16, 256, 16), (2, 32, 512, 16),
          (2, 13, 128, 8), (2, 16, 100, 16)]
TOL = {"float32": 1e-4, "bfloat16": 1e-1}


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _inputs(B, c, di, ds, seed):
    """numpy f32 (xc, dt, Bm, Cm, A, h0) as tests/test_kernels.py draws
    them."""
    rng = np.random.RandomState(seed)
    xc = rng.randn(B, c, di).astype(np.float32)
    dt = (0.1 * np.log1p(np.exp(rng.randn(B, c, di)))).astype(np.float32)
    Bm = rng.randn(B, c, ds).astype(np.float32)
    Cm = rng.randn(B, c, ds).astype(np.float32)
    A = -np.abs(rng.randn(di, ds)).astype(np.float32)
    h0 = rng.randn(B, di, ds).astype(np.float32)
    return xc, dt, Bm, Cm, A, h0


def _both(arrays, dtype):
    """The inputs for each package, the first four in ``dtype``: both
    packages round the same f32 values to bf16 the same way (to nearest
    even)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = [jnp.asarray(a).astype(jd) if i < 4 else jnp.asarray(a)
         for i, a in enumerate(arrays)]
    t = [torch.tensor(a).to(td) if i < 4 else torch.tensor(a)
         for i, a in enumerate(arrays)]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mamba_chunk_plain_matches_reference(shape, dtype):
    """B10's plain version (the wrapper on a CPU tensor) against the Pallas
    kernel in interpret mode and the oracle: y and h_last, f32 outputs
    (bf16 inputs too: all three compute in f32 from the same values)."""
    j, t = _both(_inputs(*shape, seed=sum(shape)), dtype)
    MS.reset_launches()
    y, h = MS.mamba_chunk(*t)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == shape[:3] and h.shape == (shape[0], shape[2], shape[3])
    assert MS.launches["mamba_chunk"] == 0          # CPU: the plain version
    yr, hr = jref.mamba_chunk_ref(*j)
    yk, hk = mamba_chunk_pallas(*j, interpret=True)
    for got, want in ((y, yr), (h, hr), (y, yk), (h, hk)):
        _close(got, want, 1e-4)         # f32 arithmetic in all three


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mamba_chunk_backward_plain_matches_reference(shape, dtype):
    """B11's plain version against ``mamba_chunk_backward_pallas`` in
    interpret mode and the oracle VJP, with live cotangents on both
    outputs and a non-zero h0; the gradients come in the inputs' dtypes."""
    B, c, di, ds = shape
    arrays = _inputs(*shape, seed=sum(shape) + 5)
    j, t = _both(arrays, dtype)
    rng = np.random.RandomState(sum(shape) + 6)
    dy = rng.randn(B, c, di).astype(np.float32)
    dhl = rng.randn(B, di, ds).astype(np.float32)
    got = MS.mamba_chunk_backward(*t, torch.tensor(dy), torch.tensor(dhl))
    want_o = jref.mamba_chunk_vjp_ref(*j, (jnp.asarray(dy),
                                           jnp.asarray(dhl)))
    want_k = mamba_chunk_backward_pallas(*j, jnp.asarray(dy),
                                         jnp.asarray(dhl), interpret=True)
    for g, inp in zip(got, t):
        assert g.dtype == inp.dtype and g.shape == inp.shape
    for g, wo, wk in zip(got, want_o, want_k):
        _close(g, wo, TOL[dtype])
        _close(g, wk, TOL[dtype])


def test_mamba_chunk_chains_across_chunks():
    """Carrying h across two chunks == one long reference scan."""
    B, c, di, ds = 1, 8, 128, 8
    xc, dt, Bm, Cm, A, h0 = _inputs(B, 2 * c, di, ds, seed=9)
    h0 = np.zeros_like(h0)
    t = [torch.tensor(a) for a in (xc, dt, Bm, Cm, A, h0)]
    y1, h1 = MS.mamba_chunk(*(a[:, :c] for a in t[:4]), t[4], t[5])
    y2, h2 = MS.mamba_chunk(*(a[:, c:] for a in t[:4]), t[4], h1)
    yr, hr = jref.mamba_chunk_ref(*(jnp.asarray(a) for a in
                                    (xc, dt, Bm, Cm, A, h0)))
    _close(torch.cat([y1, y2], dim=1), yr, 1e-4)
    _close(h2, hr, 1e-4)


def test_padded_steps_pass_the_state_bit_for_bit():
    """Steps with dt = 0 (a left-padded prompt's pads) leave h exactly as
    it was: a run after p pad steps equals the unpadded run bit for bit."""
    B, c, di, ds, p = 2, 12, 64, 8, 5
    xc, dt, Bm, Cm, A, h0 = (torch.tensor(a) for a in
                             _inputs(B, c, di, ds, seed=3))
    dt[:, :p] = 0
    y, h = MS.mamba_chunk(xc, dt, Bm, Cm, A, h0)
    ys, hs = MS.mamba_chunk(*(a[:, p:] for a in (xc, dt, Bm, Cm)), A, h0)
    assert torch.equal(h, hs)
    assert torch.equal(y[:, p:], ys)


def _loss_weights(B, c, di, ds, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, c, di).astype(np.float32),
            rng.randn(B, di, ds).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_autograd_function_matches_jax_grad(shape, dtype):
    """torch.autograd through ``ops.mamba_chunk`` (the forward and backward
    wrappers under ``_MambaChunk``) == jax.grad through the reference's
    ``ops.mamba_chunk`` (its Pallas pair, interpret mode) and through its
    oracle, all six inputs, live cotangents on both outputs; f32 at 2e-4
    as tests/test_kernels.py::test_mamba_grad_vs_ref."""
    B, c, di, ds = shape
    j, t = _both(_inputs(*shape, seed=sum(shape)), dtype)
    wy, wh = _loss_weights(B, c, di, ds, sum(shape) + 1)

    def jloss(f):
        def loss(*a):
            y, h = f(*a)
            return (y * wy).sum() + (h * wh).sum()
        return loss

    gk = jax.grad(jloss(jops.mamba_chunk), argnums=tuple(range(6)))(*j)
    gr = jax.grad(jloss(jref.mamba_chunk_ref), argnums=tuple(range(6)))(*j)
    leaves = [a.detach().requires_grad_(True) for a in t]
    y, h = tops.mamba_chunk(*leaves)
    assert type(y.grad_fn).__name__ == "_MambaChunkBackward"
    loss = (y * torch.tensor(wy)).sum() + (h * torch.tensor(wh)).sum()
    got = torch.autograd.grad(loss, leaves)
    tol = 2e-4 if dtype == "float32" else 1e-1
    for g, wk, wr in zip(got, gk, gr):
        _close(g, wk, tol)
        _close(g, wr, tol)


def test_autograd_multichunk_matches_one_scan():
    """Gradients through TWO chained chunks (a non-zero carried h) ==
    jax.grad through one long oracle scan (test_mamba_grad_multichunk)."""
    B, c, di, ds = 1, 8, 128, 8
    arrays = _inputs(B, 2 * c, di, ds, seed=11)
    wy = np.random.RandomState(12).randn(B, 2 * c, di).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    xc, dt, Bm, Cm, A, h0 = leaves
    y1, h1 = tops.mamba_chunk(xc[:, :c], dt[:, :c], Bm[:, :c], Cm[:, :c],
                              A, h0)
    y2, _ = tops.mamba_chunk(xc[:, c:], dt[:, c:], Bm[:, c:], Cm[:, c:], A,
                             h1)
    loss = (torch.cat([y1, y2], dim=1) * torch.tensor(wy)).sum()
    got = torch.autograd.grad(loss, leaves)
    want = jax.grad(lambda *a: (jref.mamba_chunk_ref(*a)[0] * wy).sum(),
                    argnums=tuple(range(6)))(*(jnp.asarray(a)
                                               for a in arrays))
    for g, w in zip(got, want):
        _close(g, w, 2e-4)


def test_autograd_function_runs_the_backward_wrapper(monkeypatch):
    """The Function's backward is the backward wrapper, once a chunk, with
    the six saved inputs (nothing (B, c, di, ds)-sized is saved); an unused
    h_last reaches it as a zero cotangent."""
    calls = []
    real = MS.mamba_chunk_backward

    def spy(*args):
        calls.append([tuple(a.shape) for a in args])
        return real(*args)

    monkeypatch.setattr(MS, "mamba_chunk_backward", spy)
    B, c, di, ds = 2, 8, 64, 8
    leaves = [torch.tensor(a, requires_grad=True)
              for a in _inputs(B, c, di, ds, seed=4)]
    y, _ = tops.mamba_chunk(*leaves)
    y.sum().backward()
    assert len(calls) == 1
    assert calls[0] == [(B, c, di), (B, c, di), (B, c, ds), (B, c, ds),
                        (di, ds), (B, di, ds), (B, c, di), (B, di, ds)]
    assert all(t.grad is not None for t in leaves)


def test_wrappers_check_the_kernels_limits():
    """What the CUDA kernels do not take raises before a launch (the checks
    are device-independent; here on CPU tensors)."""
    xc, dt, Bm, Cm, A, h0 = (torch.tensor(a) for a in
                             _inputs(2, 8, 64, 8, seed=0))
    assert MS._check(xc, dt, Bm, Cm, A, h0) == (2, 8, 64, 8, 0)
    with pytest.raises(TypeError):
        MS._check(xc, dt.bfloat16(), Bm, Cm, A, h0)     # mixed dtypes
    with pytest.raises(TypeError):
        MS._check(xc, dt, Bm, Cm, A.double(), h0)       # A must be f32
    with pytest.raises(TypeError):
        MS._check(xc.double(), dt, Bm, Cm, A, h0)
    with pytest.raises(ValueError):
        MS._check(xc, dt, Bm, Cm, A, h0[:1])
    with pytest.raises(ValueError):
        MS._check(xc.transpose(1, 2).contiguous().transpose(1, 2), dt, Bm,
                  Cm, A, h0)                            # not contiguous
    big = torch.zeros(2, 8, 17)
    with pytest.raises(ValueError, match="d_state"):
        MS._check(xc, dt, big, big, torch.zeros(64, 17),
                  torch.zeros(2, 64, 17))
    # a backward chunk past MAX_BWD_CHUNK (the forward takes it), a batch
    # past MAX_BATCH
    with pytest.raises(ValueError, match="backward"):
        MS.check_shape(2, MS.MAX_BWD_CHUNK + 1, 64, 16, backward=True)
    MS.check_shape(2, MS.MAX_BWD_CHUNK + 1, 64, 16, backward=False)
    with pytest.raises(ValueError, match="batch"):
        MS.check_shape(MS.MAX_BATCH + 1, 8, 64, 16, backward=False)
