"""The persistent GBN body (``csrc/gbn.cu``) on the CPU, where its kernels
cannot run: its plan (``repro_torch.kernels.gbn.plan``) and a plain-torch
model of its order held to the JAX package.

The plan is checked for what the kernels assume of it: every row of every
ghost staged exactly once, each block's shared memory within the card's
budget, the two-pass body taken exactly when a ghost is over the budget.
The model computes what the kernels compute, in their order: block p of a
group reduces rows [p * slice_rows, (p + 1) * slice_rows) of a ghost to a
per-channel partial (forward: mean and M2 from sums shifted by the slice's
first row; backward: sum dy and sum dy * xhat); every block merges the P
partials in the kernels' fixed order (``split`` threads a channel each sum a
range of partials in index order, then the ranges in order; the forward by
Chan's formula about block 0's mean); the backward forms the dx
coefficients from the merged sums and sums dgamma/dbeta over the ghosts in
ghost order. On small shapes (with plans cut to many slices) the model is
held to ``repro.kernels.ops.gbn_forward`` (Pallas, interpret mode) and
``repro.kernels.ref`` at the reference tests' tolerance (1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gbn as K

TOL = 1e-4
SMS = [132, 114, 1]
PATH_SHAPES = [(32, 131072, 16), (32, 32768, 32), (32, 8192, 64),
               (32, 128, 512), (3, 77, 200), (1, 16, 8), (2, 33, 10),
               (1, 5, 4096)]
MODEL_SHAPES = [(1, 16, 8), (4, 300, 96), (2, 1024, 128), (3, 77, 200),
                (5, 131, 13)]
# (SM count, sub-chunk bytes): the card's plan, and one cut to many slices
MODEL_PLANS = [(132, K.SUB_BYTES), (8, 1024)]


def _walk(p, G, R):
    """Per block (group k, index b): the (ghost, first row, rows) of its
    sub-chunks in the order the kernels stage them."""
    for k in range(p.ngroups):
        for b in range(p.P):
            r0 = b * p.slice_rows
            r1 = min(R, r0 + p.slice_rows)
            yield k, b, [(g, a, max(0, min(r1, a + p.sub_rows) - a))
                         for g in range(k, G, p.ngroups)
                         for a in (r0 + s * p.sub_rows
                                   for s in range(p.nsub))]


def _budget(p):
    return min(K.SMEM_PER_BLOCK,
               K.SMEM_PER_SM // p.blocks_per_sm - K.SMEM_RESERVED)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_plan_stages_every_row_once_within_the_budget(shape, sms, backward):
    G, R, C = shape
    p = K.plan(G, R, C, sms, backward=backward)
    geo = p.geometry
    seen = np.zeros((G, R), np.int64)
    if p.body == "two_pass":
        assert (geo.nchunks - 1) * geo.chunk_rows < R <= \
            geo.nchunks * geo.chunk_rows
        assert R > K.ghost_rows_budget(C, sms, backward=backward)
        return
    assert p.body == "persistent"
    assert 1 <= p.ngroups <= G and p.grid <= sms * p.blocks_per_sm
    assert p.blocks_per_sm * geo.threads <= K.THREADS_PER_SM
    assert 1 <= p.nsub <= p.nslot <= K.MAX_SLOTS
    assert p.nsub * p.sub_rows >= p.slice_rows
    assert (p.P - 1) * p.slice_rows < R <= p.P * p.slice_rows
    for _, _, items in _walk(p, G, R):
        assert len(items) == -(-G // p.ngroups) * p.nsub or \
            len(items) == (G // p.ngroups) * p.nsub
        for g, a, n in items:
            assert n <= p.sub_rows
            seen[g, a:a + n] += 1
    assert (seen == 1).all()
    # each block's staged bytes (a sub-chunk and the lead of an unaligned
    # copy a slot) and the rest of its shared memory fit its budget
    nin = 2 if backward else 1
    assert p.sub_rows * C + 3 <= p.slot_floats and p.slot_floats % 4 == 0
    assert p.smem_bytes == K.smem_bytes(p.nslot, nin, p.slot_floats, C,
                                        geo.threads, geo.vec)
    assert p.smem_bytes <= _budget(p)
    assert 4 * nin * p.slice_rows * C <= 4 * nin * p.nslot * p.slot_floats


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("C", [16, 32, 64, 10, 512])
def test_two_pass_body_exactly_when_a_ghost_is_over_the_budget(C, backward):
    rows = K.ghost_rows_budget(C, 132, backward=backward)
    assert K.plan(2, rows, C, 132, backward=backward).body == "persistent"
    assert K.plan(2, rows + 1, C, 132, backward=backward).body == "two_pass"
    # the budget is what the grid's rings hold
    p = K.plan(2, rows, C, 132, backward=backward)
    assert rows * C * 4 * (2 if backward else 1) <= \
        132 * p.blocks_per_sm * _budget(p)


def test_two_pass_body_at_the_large_ghosts():
    assert K.plan(2, 2 ** 20, 16, 132, backward=False).body == "two_pass"
    assert K.plan(2, 2 ** 19, 16, 132, backward=True).body == "two_pass"
    # ghost 128 at B=4096 on the card: every ResNet44 and F1 layer fits
    for G, R, C in PATH_SHAPES[:4]:
        for backward in (False, True):
            assert K.plan(G, R, C, 132, backward=backward).body == \
                "persistent"


@pytest.mark.parametrize("shape", [(1, 8, 4100), (65536, 4, 8), (0, 4, 8),
                                   (1, 8, 1025)])
def test_plan_rejects_shapes_past_both_bodies(shape):
    for backward in (False, True):
        with pytest.raises(ValueError):
            K.plan(*shape, 132, backward=backward)


def test_plan_reads_the_shape_and_card_only():
    """The same shape, SM count and alignment give the same plan, whatever
    was planned before (a plain function of its arguments)."""
    a = K.plan(32, 8192, 64, 132, backward=True)
    K.plan.cache_clear()
    K.plan(2, 2 ** 20, 16, 132, backward=True)
    assert K.plan(32, 8192, 64, 132, backward=True) == a


# ---------------------------------------------------------------------------
# a plain-torch model of the persistent body's order
# ---------------------------------------------------------------------------


def _slices(p, R):
    return [(q * p.slice_rows, min(R, (q + 1) * p.slice_rows))
            for q in range(p.P)]


def _merge(p, C, terms, block):
    """merge2 of csrc/gbn.cu as block ``block`` runs it: ``terms`` (P, 2, C)
    summed over P, each channel in the same fixed order whichever block
    merges (every block reads all P partials from memory)."""
    del block
    NT = p.geometry.threads
    P = terms.shape[0]
    split = 1 if C >= NT else NT // C
    per = -(-P // split)
    total = torch.zeros(2, C)
    for j in range(split):
        part = torch.zeros(2, C)
        for q in range(j * per, min(P, (j + 1) * per)):
            part = part + terms[q]
        total = total + part
    return total


def _model_forward(x, gamma, beta, p, eps=1e-5, block=0):
    G, R, C = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(G, C)
    var = torch.empty(G, C)
    for g in range(G):
        parts = []
        for a, b in _slices(p, R):
            xs = x[g, a:b]
            d = xs - xs[0]
            s1, s2, n = d.sum(0), (d * d).sum(0), float(b - a)
            parts.append((n, xs[0] + s1 / n,
                          torch.clamp(s2 - s1 * (s1 / n), min=0.0)))
        m0 = parts[0][1]
        terms = torch.stack([torch.stack([n * (m - m0),
                                          m2 + n * (m - m0) * (m - m0)])
                             for n, m, m2 in parts])
        A, B = _merge(p, C, terms, block)
        mu[g] = m0 + A / R
        var[g] = torch.clamp(B - A * (A / R), min=0.0) / R
        y[g] = (x[g] - mu[g]) * torch.rsqrt(var[g] + eps) * gamma + beta
    return y, mu, var


def _model_backward(x, gamma, mu, var, dy, dmu, dvar, p, eps=1e-5,
                    block=0):
    G, R, C = x.shape
    dx = torch.empty_like(x)
    gsdy = torch.empty(G, C)
    gsdyxh = torch.empty(G, C)
    for g in range(G):
        rs = torch.rsqrt(var[g] + eps)
        terms = torch.stack([
            torch.stack([dy[g, a:b].sum(0),
                         (dy[g, a:b] * ((x[g, a:b] - mu[g]) * rs)).sum(0)])
            for a, b in _slices(p, R)])
        sdy, sdyxh = _merge(p, C, terms, block)
        gvar = dvar[g] - 0.5 * gamma * rs * rs * sdyxh
        gmu = dmu[g] - gamma * rs * sdy
        dx[g] = dy[g] * (gamma * rs) + (x[g] - mu[g]) * (2.0 * gvar / R) \
            + gmu / R
        gsdy[g], gsdyxh[g] = sdy, sdyxh
    dgamma, dbeta = torch.zeros(C), torch.zeros(C)
    for g in range(G):            # ghost order
        dgamma = dgamma + gsdyxh[g]
        dbeta = dbeta + gsdy[g]
    return dx, dgamma, dbeta


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    G, R, C = shape
    x = (2.0 * rng.randn(G, R, C) + 0.5).astype(np.float32)
    gamma = np.linspace(0.5, 1.5, C, dtype=np.float32)
    beta = np.linspace(-1.0, 1.0, C, dtype=np.float32)
    cts = (rng.randn(G, R, C).astype(np.float32),
           rng.randn(G, C).astype(np.float32),
           rng.randn(G, C).astype(np.float32))
    return x, gamma, beta, cts


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


def _model_plans(shape, backward):
    G, R, C = shape
    return [K.plan(G, R, C, sms, backward=backward, sub_bytes=sub)
            for sms, sub in MODEL_PLANS]


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_model_forward_matches_reference(shape):
    x, gamma, beta, _ = _inputs(shape, sum(shape))
    want = [jops.gbn_forward(jnp.asarray(x), gamma, beta),
            jref.gbn_ref(x, gamma, beta)]
    for p in _model_plans(shape, backward=False):
        assert p.body == "persistent"
        got = _model_forward(torch.tensor(x), torch.tensor(gamma),
                             torch.tensor(beta), p)
        for jout in want:
            for a, b in zip(got, jout):
                _close(a, b)


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_model_backward_matches_reference(shape):
    """dx, dgamma, dbeta of the model (from the model forward's mu/var, with
    live cotangents on all three outputs) against the JAX custom_vjp
    (Pallas backward, interpret) and the hand VJP."""
    x, gamma, beta, cts = _inputs(shape, 3 * sum(shape))
    _, vjp = jax.vjp(lambda a, g, b: jops.gbn_forward(a, g, b),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = [vjp(tuple(jnp.asarray(c) for c in cts)),
            jref.gbn_vjp_ref(x, gamma, beta, cts)]
    xt, gt, bt = (torch.tensor(a) for a in (x, gamma, beta))
    for pf, pb in zip(_model_plans(shape, False), _model_plans(shape, True)):
        assert pb.body == "persistent"
        _, mu, var = _model_forward(xt, gt, bt, pf)
        got = _model_backward(xt, gt, mu, var,
                              *(torch.tensor(c) for c in cts), pb)
        for jout in want:
            for a, b in zip(got, jout):
                _close(a, b)


@pytest.mark.parametrize("shape", [(3, 77, 200), (5, 131, 13)])
def test_model_merge_gives_the_same_bits_in_every_block(shape):
    x, gamma, beta, cts = _inputs(shape, 11)
    xt, gt, bt = (torch.tensor(a) for a in (x, gamma, beta))
    ct = [torch.tensor(c) for c in cts]
    pf, pb = (K.plan(*shape, 4, backward=b, sub_bytes=256, depth=3)
              for b in (False, True))
    assert pf.P > 1 and pb.P > 1
    f0 = _model_forward(xt, gt, bt, pf, block=0)
    b0 = _model_backward(xt, gt, f0[1], f0[2], *ct, pb, block=0)
    for blk in range(1, max(pf.P, pb.P)):
        fb = _model_forward(xt, gt, bt, pf, block=min(blk, pf.P - 1))
        bb = _model_backward(xt, gt, f0[1], f0[2], *ct, pb,
                             block=min(blk, pb.P - 1))
        assert all(a.equal(b) for a, b in zip(f0 + b0, fb + bb))
    # the order is the point: another order of the same partials moves bits
    rng = np.random.RandomState(0)
    terms = torch.tensor((rng.randn(64, 2, shape[2])
                          * 10.0 ** rng.uniform(-3, 3, (64, 2, shape[2])))
                         .astype(np.float32))
    fixed = _merge(pb, shape[2], terms, 0)
    assert fixed.equal(_merge(pb, shape[2], terms.clone(), 63))
    assert not fixed.equal(_merge(pb, shape[2], terms.flip(0), 0))
