"""The row-team RMSNorm kernels (``csrc/rmsnorm_residual.cu``) on the CPU,
where they cannot run: their plan (``repro_torch.kernels.fused_norm.plan``)
and a plain-torch model of their order held to the JAX package.

The plan is checked for what the kernels assume of it: a team fixed by the
width alone (the same for every N), every row taken by exactly one team and
every block given a row, every chunk of a row held by one thread, the
register cap and shared memory within the card's limits, and the count of
dscale partials fixed by N, d and the SM count.

The model computes what the kernels compute, in their order: thread t of a
team of W warps holds chunks t, t + 32 W, ... of V elements, sums each
chunk's squares in element order and the chunk sums in chunk order; a
butterfly over each warp's 32 lanes; the warp sums in warp order. The backward's dscale adds
each team's rows in row order, the teams of a block in team order, then
8 runs of consecutive blocks each in block order, and the runs in order. Held to ``rmsnorm_residual_pallas`` and
``rmsnorm_residual_backward_pallas`` (interpret mode) at 1e-5 in f32; a
row's result is the same bits in a batch of 1 and of 64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels.fused_norm import (rmsnorm_residual_backward_pallas,
                                      rmsnorm_residual_pallas)
from repro_torch.kernels import fused_norm as FN

SMS = [132, 114, 1]
WIDTHS = [1024, 2048, 3840, 4096, 5120, 5376, 7168, 8192, 7, 100, 128, 256]
ROWS = [1, 8, 17, 4096, 32768]
SMEM_PER_SM = 233472
STATIC_SMEM = 8 * 2 * 8 * 8        # the team sums' slots (float2)
TOL = 1e-5
DSCALE_RUNS = 8                    # csrc kDscaleRuns


def _regs_held(backward, per_lane, itemsize):
    """Registers a thread of the rows body needs at least, by count of what
    it holds: raw 16-byte chunks (4 registers each) of the current and the
    next row (forward: s, next x and r; backward: s, dy, ds twice), the
    backward's f32 dscale partial, and ~40 for addresses and temporaries."""
    if backward:
        return 4 * per_lane * 6 + per_lane * (16 // itemsize) + 40
    return 4 * per_lane * 3 + 40


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_plan(d, backward):
    for itemsize in (2, 4):
        V = 16 // itemsize
        chunks = -(-d // V)
        teams = {FN.team(d, itemsize, backward=backward)}
        for sms in SMS:
            for N in ROWS:
                p = FN.plan(N, d, sms, backward=backward, itemsize=itemsize)
                assert p == FN.plan(N, d, sms, backward=backward,
                                    itemsize=itemsize)
                teams.add((p.body, p.warps, p.per_lane))
                assert p.vec == V
                # every row exactly once: team g takes g, g + teams, ...
                taken = np.concatenate([np.arange(g, N, p.teams)
                                        for g in range(p.teams)])
                assert np.array_equal(np.bincount(taken, minlength=N),
                                      np.ones(N))
                assert p.blocks <= -(-N // p.teams_per_block)  # none empty
                # every chunk of a row held by one thread of the team
                if p.body == "rows":
                    assert p.per_lane in FN.PER_LANE[backward]
                    assert p.per_lane * 32 * p.warps >= chunks
                    # the least K at the fewest warps
                    assert all(k * 32 * p.warps < chunks
                               for k in FN.PER_LANE[backward]
                               if k < p.per_lane)
                    assert p.warps == 1 or chunks > 16 * p.warps * \
                        FN.KMAX[backward]
                    assert _regs_held(backward, p.per_lane,
                                      itemsize) <= p.regs
                else:
                    assert backward and chunks > 32 * 8 * 4
                    assert (p.warps, p.teams_per_block) == (8, 1)
                # the card's limits
                assert p.warps in FN.WARPS
                assert p.threads <= FN.THREADS and p.threads % 32 == 0
                assert p.teams_per_block <= 8      # named barriers 1..8
                assert p.regs <= FN.MAX_REGS
                assert p.threads * p.regs * p.blocks_per_sm <= FN.REGS_PER_SM
                smem = p.smem_bytes + STATIC_SMEM
                assert smem <= (FN.SMEM_PER_BLOCK if p.body == "rows"
                                else FN.STREAM_SMEM_MAX)
                assert (smem + 1024) * p.blocks_per_sm <= SMEM_PER_SM
                # the dscale partials: one a block, fixed by N, d and sms
                assert 1 <= p.blocks <= sms * p.blocks_per_sm
                assert p.blocks == min(-(-N // p.teams_per_block),
                                       sms * p.blocks_per_sm)
        assert len(teams) == 1, f"the team depends on N or sms: {teams}"


def test_plan_spreads_few_rows_and_fills_the_card():
    """Decode rows take one team a block over as many SMs; a 4096-row call
    fills every SM at the blocks its register cap allows."""
    for backward in (False, True):
        p = FN.plan(8, 2048, 132, backward=backward)
        assert (p.teams_per_block, p.blocks) == (1, 8)
    for backward in (False, True):
        p = FN.plan(4096, 2048, 132, backward=backward)
        assert p.blocks == 132 * p.blocks_per_sm
        assert p.threads == FN.THREADS


# ---------------------------------------------------------------------------
# the model of the kernels' order
# ---------------------------------------------------------------------------


def _team_sum(v, W, K, V):
    """Per row of v (N, d) f32: the sum of its elements in a team's order."""
    N, d = v.shape
    TT = 32 * W
    pad = torch.zeros(N, K * TT * V, dtype=v.dtype)
    pad[:, :d] = v
    chunks = pad.view(N, K, TT, V)              # chunk k * TT + t
    part = torch.zeros(N, TT, dtype=v.dtype)
    for k in range(K):
        q = torch.zeros(N, TT, dtype=v.dtype)
        for e in range(V):
            q = q + chunks[:, k, :, e]
        part = part + q
    part = part.view(N, W, 32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, :, torch.arange(32) ^ o]
    total = part[:, 0, 0]
    for w in range(1, W):
        total = total + part[:, w, 0]
    return total


def _order(p, d):
    """(W, K) of a plan: the stream body sums in the order of a team of 8
    warps holding all of its chunks."""
    if p.body == "rows":
        return p.warps, p.per_lane
    chunks = -(-d // p.vec)
    return p.warps, -(-chunks // (32 * p.warps))


def model_forward(x, r, scale, sms=132, eps=1e-6):
    N, d = x.shape
    p = FN.plan(N, d, sms, backward=False, itemsize=x.element_size())
    s = x if r is None else x + r
    sf = s.float()
    ss = _team_sum(sf * sf, *_order(p, d), p.vec)
    rstd = torch.rsqrt(ss / d + eps)[:, None]
    return (sf * rstd * scale.float()).to(x.dtype), s


def model_backward(s, scale, dy, ds, sms=132, eps=1e-6):
    N, d = s.shape
    p = FN.plan(N, d, sms, backward=True, itemsize=s.element_size())
    W, K = _order(p, d)
    sf, g, sc = s.float(), dy.float(), scale.float()
    rstd = torch.rsqrt(_team_sum(sf * sf, W, K, p.vec) / d + eps)[:, None]
    m = _team_sum(g * sc * sf, W, K, p.vec)[:, None] * rstd / d
    sh = sf * rstd
    dx = rstd * (g * sc - sh * m)
    if ds is not None:
        dx = dx + ds.float()
    contrib = g * sh
    team_acc = torch.zeros(p.teams, d)
    for i in range(N):                       # each team's rows in order
        team_acc[i % p.teams] = team_acc[i % p.teams] + contrib[i]
    blk = []                                 # each block's teams in order
    for b in range(p.blocks):
        acc = team_acc[b * p.teams_per_block]
        for j in range(1, p.teams_per_block):
            acc = acc + team_acc[b * p.teams_per_block + j]
        blk.append(acc)
    per = -(-p.blocks // DSCALE_RUNS)        # runs of blocks, each in order,
    runs = []                                # then the runs in order
    for g in range(DSCALE_RUNS):
        acc = torch.zeros(d)
        for b in range(g * per, min(p.blocks, (g + 1) * per)):
            acc = acc + blk[b]
        runs.append(acc)
    dscale = runs[0]
    for acc in runs[1:]:
        dscale = dscale + acc
    return dx.to(s.dtype), dscale


# (N, d, sms): one-warp teams, multi-warp teams (f32 d 2048: forward 2
# warps, backward 4), several teams a block (1 SM), the backward's stream
# body (d 8192 f32), a width off the 16-byte chunk
MODEL_CASES = [(17, 128, 132), (33, 256, 1), (16, 2048, 132), (9, 1024, 1),
               (5, 100, 1), (3, 8192, 132)]


def _inputs(N, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(N, d).astype(np.float32) for _ in range(4)] + [
        np.linspace(0.5, 1.5, d).astype(np.float32)]


@pytest.mark.parametrize("N,d,sms", MODEL_CASES)
def test_model_matches_pallas(N, d, sms):
    x, r, dy, ds, scale = _inputs(N, d, N + d)
    t = [torch.from_numpy(a) for a in (x, r, dy, ds, scale)]
    y, s = model_forward(t[0], t[1], t[4], sms)
    jy, js = rmsnorm_residual_pallas(jnp.asarray(x), jnp.asarray(r),
                                     jnp.asarray(scale), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    for dsv in (t[3], None):
        dx, dscale = model_backward(s, t[4], t[2], dsv, sms)
        jdx, jdscale = rmsnorm_residual_backward_pallas(
            jnp.asarray(s.numpy()), jnp.asarray(scale), jnp.asarray(dy),
            jnp.asarray(ds if dsv is not None else np.zeros_like(ds)),
            interpret=True)
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(dscale.numpy(), np.asarray(jdscale),
                                   rtol=TOL, atol=TOL * N)


@pytest.mark.parametrize("d", [128, 2048, 8192, 100])
def test_model_row_is_batch_invariant(d):
    """A row's y, s and dx in a batch of 64 equal, bit for bit, the row
    computed alone: the order depends on d only."""
    x, r, dy, ds, scale = (torch.from_numpy(a) for a in _inputs(64, d, d))
    y, s = model_forward(x, r, scale)
    dx, _ = model_backward(s, scale, dy, ds)
    for i in (0, 1, 31, 63):
        yi, si = model_forward(x[i:i + 1], r[i:i + 1], scale)
        dxi, _ = model_backward(si, scale, dy[i:i + 1], ds[i:i + 1])
        assert torch.equal(yi[0], y[i]) and torch.equal(si[0], s[i])
        assert torch.equal(dxi[0], dx[i])
