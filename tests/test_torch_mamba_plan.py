"""The Hopper Mamba chunk-scan pair (``csrc/mamba_scan.cu``) on the CPU,
where its kernels cannot run: the model of its launch
(``tests/_mamba_plan_model.py``, which the card tests hold the built
library's plan to) and a plain-torch model of its order held to the JAX
package.

The launch is checked for what the kernels assume of it: every (row,
channel, state) owned by exactly one thread, at the kernels' block and at a
narrower one; the wrappers refuse shapes past the kernels' limits.

The model computes what the kernels compute, in their order: states padded
to DS, a thread's Q states summed in state order and the lanes of a channel
by a butterfly (xor 1, 2, ...); for B11 the sums over channels of dB and dC
as the kernel's reduce-scatter (a warp's channels halved from the top lane
bit down), the warps of a block in warp order and the blocks' partial rows
in tile order. On the reference tests' shapes it is held to
``mamba_chunk_pallas``/``mamba_chunk_backward_pallas`` in interpret mode at
the reference tests' tolerance (1e-4), and its dA to float64 autograd."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mamba_plan_model import model_plan, owners
from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels.mamba_scan import (mamba_chunk_backward_pallas,
                                      mamba_chunk_pallas)
from repro_torch.kernels import mamba_scan as MS

TOL = 1e-4
# tests/test_torch_ssm_kernels.py:SHAPES, the falcon-mamba path and its solo
# row, d_inner 100 and 8200, d_state 5, 8 and 16
SHAPES = [(1, 8, 128, 8), (2, 16, 256, 16), (2, 32, 512, 16),
          (2, 13, 128, 8), (2, 16, 100, 16)]
PLAN_SHAPES = SHAPES + [(8, 256, 8192, 16), (1, 256, 8192, 16),
                        (2, 256, 100, 16), (2, 256, 8200, 16),
                        (3, 40, 200, 5), (2, 64, 8200, 8), (1, 7, 64, 16)]
# the kernels' blocks, and a narrow one (many warps' and tiles' sums at the
# model tests' small widths)
THREADS = [None, 64]


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_state_once(shape, threads, backward):
    B, c, di, ds = shape
    p = model_plan(*shape, backward, threads=threads)
    assert p.DS in (8, 16) and ds <= p.DS and p.DS == p.q * p.lanes
    assert p.lanes <= 32 and 32 % p.lanes == 0
    assert p.channels * p.lanes == p.threads
    assert p.grid == (-(-di // p.channels), B)
    assert (p.grid[0] - 1) * p.channels < di <= p.grid[0] * p.channels
    assert (p.nseg - 1) * p.steps < c <= p.nseg * p.steps
    assert (owners(p, di, ds) == 1).all()


@pytest.mark.parametrize("kw", [
    dict(shape=(2, 8, 64, 17)), dict(shape=(65536, 8, 64, 16)),
    dict(shape=(2, 0, 64, 16)), dict(shape=(2, 8, 0, 16)),
    dict(shape=(2, 8, 64, 0)),
    dict(shape=(1, 2049, 64, 16), backward=True)])
def test_plan_rejects_shapes_past_the_limits(kw):
    kw = dict(kw)
    shape = kw.pop("shape")
    backward = kw.pop("backward", False)
    with pytest.raises(ValueError):
        MS.check_shape(*shape, backward=backward)
    if not backward:
        with pytest.raises(ValueError):
            MS.check_shape(*shape, backward=True)


# ---------------------------------------------------------------------------
# a plain-torch model of the kernels' order
# ---------------------------------------------------------------------------


def _seq_sum(x, dim):
    """Sum along ``dim`` one term after another, in index order."""
    dim = dim % x.dim()
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _lanes_sum(x, dim):
    """The butterfly xor 1, 2, ... over lanes along ``dim`` (adjacent lanes
    first)."""
    dim = dim % x.dim()
    while x.shape[dim] > 1:
        n = x.shape[dim] // 2
        x = x.unflatten(dim, (n, 2))
        x = x.select(dim + 1, 0) + x.select(dim + 1, 1)
    return x.squeeze(dim)


def _warp_sum(x, dim):
    """The reduce-scatter over a warp's channels along ``dim``: halves from
    the top lane bit down."""
    while x.shape[dim] > 1:
        n = x.shape[dim] // 2
        x = x.narrow(dim, 0, n) + x.narrow(dim, n, n)
    return x.squeeze(dim)


def _s_sum(v, p):
    """A channel's sum over its DS states (..., DS): each lane's q states in
    order, then the butterfly over its lanes."""
    lanes = v.unflatten(-1, (p.lanes, p.q))
    return _lanes_sum(_seq_sum(lanes, -1), -1)


def _pad(p, xc, dt, Bm, Cm, A, h0, dy=None, dhl=None):
    """Everything in f32, states padded to DS and channels to whole tiles
    with zeros (as the kernels zero-fill them)."""
    B, c, di = xc.shape
    ds = Bm.shape[2]
    dp = p.grid[0] * p.channels - di
    sp = p.DS - ds

    def chan(t):
        return torch.nn.functional.pad(t.float(), (0, dp))

    def states(t, dpad=0):
        return torch.nn.functional.pad(t.float(), (0, sp, 0, dpad))

    out = [chan(xc), chan(dt), states(Bm), states(Cm), states(A, dp),
           states(h0, dp)]
    if dy is not None:
        out += [chan(dy), states(dhl, dp)]
    return out


def model_forward(p, xc, dt, Bm, Cm, A, h0):
    """B10 in its order: (y, h_last)."""
    B, c, di = xc.shape
    ds = Bm.shape[2]
    x, dt_, Bp, Cp, Ap, h = _pad(p, xc, dt, Bm, Cm, A, h0)
    ys = []
    for t in range(c):
        dtk = dt_[:, t, :, None]
        h = torch.exp(dtk * Ap) * h + (dtk * x[:, t, :, None]) * \
            Bp[:, t, None, :]
        ys.append(_s_sum(h * Cp[:, t, None, :], p))
    return torch.stack(ys, 1)[:, :, :di], h[:, :di, :ds]


def model_backward(p, xc, dt, Bm, Cm, A, h0, dy, dhl):
    """B11 in its order: (dxc, ddt, dB, dC, dA, dh0, dA per row)."""
    B, c, di = xc.shape
    ds = Bm.shape[2]
    x, dt_, Bp, Cp, Ap, h0p, dyp, dh = _pad(p, xc, dt, Bm, Cm, A, h0, dy,
                                            dhl)
    hs, decs, h = [], [], h0p
    for t in range(c):     # the states, as the segments recompute them
        dtk = dt_[:, t, :, None]
        dec = torch.exp(dtk * Ap)
        h = dec * h + (dtk * x[:, t, :, None]) * Bp[:, t, None, :]
        hs.append(h)
        decs.append(dec)
    tiles = p.grid[0]
    nw, cpw = p.threads // 32, 32 // p.lanes
    dacc = torch.zeros_like(h0p)
    dxs, ddts, dBs, dCs = [None] * c, [None] * c, [None] * c, [None] * c
    for t in reversed(range(c)):
        dtk, xk, dyk = dt_[:, t, :, None], x[:, t, :, None], \
            dyp[:, t, :, None]
        hp = hs[t - 1] if t else h0p
        g = dh + dyk * Cp[:, t, None, :]
        du = g * hp * decs[t]
        dacc = dacc + du * dtk
        gb = _s_sum(g * Bp[:, t, None, :], p)
        ga = _s_sum(du * Ap, p)
        dxs[t] = dt_[:, t] * gb
        ddts[t] = ga + x[:, t] * gb
        rows = []
        for v in (g * (dtk * xk), hs[t] * dyk):      # (B, Dp, DS)
            w = v.unflatten(1, (tiles, nw, cpw))      # (B, tiles, NW, CPW, DS)
            w = _warp_sum(w, 3)                       # within each warp
            w = _seq_sum(w, 2)                        # warps in order
            rows.append(_seq_sum(w, 1))               # tiles in order
        dBs[t], dCs[t] = rows[0][:, :ds], rows[1][:, :ds]
        dh = g * decs[t]
    dA_b = dacc[:, :di, :ds]
    return (torch.stack(dxs, 1)[:, :, :di], torch.stack(ddts, 1)[:, :, :di],
            torch.stack(dBs, 1), torch.stack(dCs, 1), dA_b.sum(0),
            dh[:, :di, :ds], dA_b)


def _inputs(B, c, di, ds, seed):
    rng = np.random.RandomState(seed)
    xc = rng.randn(B, c, di).astype(np.float32)
    dt = (0.1 * np.log1p(np.exp(rng.randn(B, c, di)))).astype(np.float32)
    Bm = rng.randn(B, c, ds).astype(np.float32)
    Cm = rng.randn(B, c, ds).astype(np.float32)
    A = -np.abs(rng.randn(di, ds)).astype(np.float32)
    h0 = rng.randn(B, di, ds).astype(np.float32)
    dy = rng.randn(B, c, di).astype(np.float32)
    dhl = rng.randn(B, di, ds).astype(np.float32)
    return xc, dt, Bm, Cm, A, h0, dy, dhl


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", SHAPES)
def test_model_forward_matches_pallas(shape, threads):
    arrays = _inputs(*shape, seed=sum(shape))
    p = model_plan(*shape, False, threads=threads)
    y, h = model_forward(p, *(torch.tensor(a) for a in arrays[:6]))
    yk, hk = mamba_chunk_pallas(*(jnp.asarray(a) for a in arrays[:6]),
                                interpret=True)
    _close(y, yk)
    _close(h, hk)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", SHAPES)
def test_model_backward_matches_pallas(shape, threads):
    arrays = _inputs(*shape, seed=sum(shape) + 5)
    p = model_plan(*shape, True, threads=threads)
    got = model_backward(p, *(torch.tensor(a) for a in arrays))
    want = mamba_chunk_backward_pallas(*(jnp.asarray(a) for a in arrays),
                                       interpret=True)
    for g, w in zip(got[:6], want):
        _close(g, w)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_model_dA_matches_float64_autograd(shape):
    """dA, a sum of B x c terms a (channel, state), against autograd
    through the recurrence in float64."""
    arrays = _inputs(*shape, seed=sum(shape) + 9)
    p = model_plan(*shape, True)
    got = model_backward(p, *(torch.tensor(a) for a in arrays))[4]
    xc, dt, Bm, Cm, A, h, dy, dhl = (torch.tensor(a, dtype=torch.float64)
                                     for a in arrays)
    A.requires_grad_(True)
    loss = 0.0
    for t in range(xc.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * xc[:, t])[:, :, None] * Bm[:, t, None, :]
        loss = loss + (torch.einsum("bds,bs->bd", h, Cm[:, t]) *
                       dy[:, t]).sum()
    loss = loss + (h * dhl).sum()
    want, = torch.autograd.grad(loss, A)
    _close(got, want.detach())


def test_model_row_alone_equals_row_in_batch():
    """The plan's order gives a row the same bits alone and in a batch:
    every output of row r, dA's per-row slice included."""
    B, c, di, ds = 3, 24, 160, 16
    arrays = [torch.tensor(a) for a in _inputs(B, c, di, ds, seed=2)]
    batch = model_backward(model_plan(B, c, di, ds, True),
                           *arrays)
    fwd = model_forward(model_plan(B, c, di, ds, False),
                        *arrays[:6])
    for r in range(B):
        one = [t[r:r + 1] if t.dim() == 3 and t.shape[0] == B else t
               for t in arrays]
        solo = model_backward(model_plan(1, c, di, ds, True),
                              *one)
        for i in (0, 1, 2, 3, 5, 6):
            assert torch.equal(solo[i], batch[i][r:r + 1]), i
        y1, h1 = model_forward(model_plan(1, c, di, ds, False),
                               *one[:6])
        assert torch.equal(y1, fwd[0][r:r + 1])
        assert torch.equal(h1, fwd[1][r:r + 1])
