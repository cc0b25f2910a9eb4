"""The serving path's four kernels, held to the JAX package on the CPU: each
port wrapper (which takes its plain version for a CPU tensor) and each
plain version against the Pallas kernel in interpret mode and its
``repro.kernels.ref`` oracle, at the reference tests' grids plus ragged
shapes, f32. A left-pad row of flash attention (t < kv_offsets[b]) sees
no key: the port gives it the mean of V over the S keys, as the
reference's attention (``repro.models.layers._sdpa``) does, and as the
Pallas kernel does where one of its blocks holds exactly the S keys; with
several blocks the Pallas value depends on its block size, so there pad
rows are held to ``_sdpa`` alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import (flash_decode_blockwise,
                                        flash_decode_pallas)
from repro.kernels.fused_norm import rmsnorm_residual_pallas
from repro.kernels.swiglu import swiglu_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swiglu as SW


def _close(got, want, tol, rtol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# fused rmsnorm + residual (tests/test_fused_kernels.py:42 grid + ragged d)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(17, 128), (64, 256), (5, 512), (3, 100),
                                   (1, 7)])
def test_rmsnorm_residual_matches_reference(shape):
    N, d = shape
    rng = np.random.RandomState(N + d)
    x, r = _randn(rng, N, d), _randn(rng, N, d)
    scale = np.linspace(0.5, 1.5, d, dtype=np.float32)
    y, s = FN.rmsnorm_residual(*map(torch.tensor, (x, r, scale)))
    yr, sr = jref.rmsnorm_residual_ref(x, r, scale)
    _close(y, yr, 1e-5)
    _close(s, sr, 1e-5)
    if d % 128 == 0:                 # the Pallas kernel's lane gate
        yk, sk = rmsnorm_residual_pallas(x, r, scale, interpret=True)
        _close(y, yk, 1e-5)
        _close(s, sk, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(17, 128), (5, 512), (3, 100), (1, 7)])
def test_rmsnorm_without_residual_matches_reference(shape, dtype):
    """``r=None``: the wrapper's plain RMSNorm equals the JAX package's
    ``rmsnorm_apply`` (the pre-attention and final norms) and the fused
    norm with a zero residual; s is x itself."""
    N, d = shape
    rng = np.random.RandomState(N * d)
    x = _randn(rng, N, d)
    scale = np.linspace(0.5, 1.5, d, dtype=np.float32)
    xt = torch.tensor(x).to(getattr(torch, dtype))
    y, s = FN.rmsnorm_residual(xt, None, torch.tensor(scale))
    assert s is xt
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, xj)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(y.float(), np.asarray(want, np.float32), tol)
    yz, _ = tops.rmsnorm_residual(xt, torch.zeros_like(xt),
                                  torch.tensor(scale))
    assert torch.equal(y, yz)


def test_rmsnorm_residual_bf16_plain_matches_reference():
    """bf16 in, bf16 out: the plain version rounds s before the norm as the
    oracle does (2e-2, the reference tests' bf16 bound)."""
    rng = np.random.RandomState(3)
    x, r = _randn(rng, 9, 256), _randn(rng, 9, 256)
    scale = np.linspace(0.5, 1.5, 256, dtype=np.float32)
    xb, rb = (torch.tensor(a).bfloat16() for a in (x, r))
    y, s = tref.rmsnorm_residual_ref(xb, rb, torch.tensor(scale))
    yr, sr = jref.rmsnorm_residual_ref(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(r, jnp.bfloat16), scale)
    _close(y.float(), yr, 2e-2)
    _close(s.float(), sr, 2e-2)


# ---------------------------------------------------------------------------
# fused SwiGLU (tests/test_fused_kernels.py:129 grid + ragged dims)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(9, 128, 256), (33, 256, 384), (5, 100, 72),
                                   (1, 64, 130)])
def test_swiglu_matches_reference(shape):
    N, d, F = shape
    rng = np.random.RandomState(sum(shape))
    x = _randn(rng, N, d)
    wg, wu = _randn(rng, d, F, scale=d ** -0.5), _randn(rng, d, F,
                                                         scale=d ** -0.5)
    h, g = SW.swiglu(*map(torch.tensor, (x, wg, wu)))
    hr, gr = jref.swiglu_ref(x, wg, wu)
    _close(h, hr, 1e-5)
    _close(g, gr, 1e-5)
    if d % 128 == 0 and F % 128 == 0:
        hk, gk = swiglu_pallas(x, wg, wu, interpret=True)
        _close(h, hk, 1e-5)
        _close(g, gk, 1e-5)


# ---------------------------------------------------------------------------
# flash attention forward (tests/test_kernels.py:17 grid, kv_offsets)
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (B, H, KV, T, S, hd), causal, window, offsets
    ((1, 2, 2, 17, 17, 32), True, None, None),
    ((2, 4, 2, 64, 64, 64), True, 13, None),
    ((1, 8, 1, 128, 128, 64), True, None, None),          # MQA
    ((2, 4, 4, 100, 100, 128), False, None, None),         # MHA, ragged T
    ((3, 4, 2, 40, 40, 64), True, None, (0, 7, 39)),        # ragged prefill
    ((2, 4, 1, 33, 33, 32), True, 9, (5, 0)),              # + window
]


def _attn_inputs(shape, seed):
    B, H, KV, T, S, hd = shape
    rng = np.random.RandomState(seed)
    return (_randn(rng, B, H, T, hd), _randn(rng, B, KV, S, hd),
            _randn(rng, B, KV, S, hd))


@pytest.mark.parametrize("shape,causal,window,offs", ATTN_CASES)
def test_flash_attention_matches_reference(shape, causal, window, offs):
    B, H, KV, T, S, hd = shape
    q, k, v = _attn_inputs(shape, sum(shape))
    off = None if offs is None else np.array(offs, np.int32)
    toff = None if off is None else torch.tensor(off)
    o, lse = FA.flash_attention_fwd(*map(torch.tensor, (q, k, v)),
                                    causal=causal, window=window,
                                    kv_offsets=toff, return_lse=True)
    ok, lk = flash_attention_pallas(
        q, k, v, causal=causal, window=window, block_q=32, block_k=32,
        kv_offsets=None if off is None else jnp.asarray(off),
        return_residuals=True, interpret=True)
    real = np.ones((B, 1, T), bool) if off is None else \
        (np.arange(T)[None, None, :] >= off[:, None, None])
    o, lse = o.numpy(), lse.numpy()
    rows = np.broadcast_to(real, (B, H, T))
    _close(o[rows], np.asarray(ok)[rows], 2e-5)
    _close(lse[rows], np.asarray(lk)[rows], 2e-5)
    if off is None:
        _close(o, jref.attention_ref(q, k, v, causal=causal, window=window),
               2e-5)
    else:            # every row, pads included, against the model's softmax
        mask = (np.ones((T, S), bool) if not causal
                else np.arange(S)[None] <= np.arange(T)[:, None])
        if window is not None:
            mask &= np.arange(S)[None] > np.arange(T)[:, None] - window
        mask = mask[None] & (np.arange(S)[None, None] >= off[:, None, None])
        want = jlayers._sdpa(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)),
                        jnp.asarray(mask)).swapaxes(1, 2)
        _close(o, want, 2e-5)
        assert np.isneginf(lse[~rows]).all()


def test_flash_attention_adapter_matches_reference():
    """The model-layout adapter (B, T, H, hd) with kv_offsets against the
    JAX package's ``ops.flash_attention`` (forward-only offsets path): at
    T = 24 the Pallas kernel holds the keys in one block, so its pad rows
    are the mean of V over the 24 keys, as the port's."""
    q, k, v = _attn_inputs((2, 4, 2, 24, 24, 64), 5)
    qm, km, vm = (a.swapaxes(1, 2) for a in (q, k, v))
    off = np.array([3, 0], np.int32)
    got = tops.flash_attention(*map(torch.tensor, (qm, km, vm)),
                               kv_offsets=torch.tensor(off)).numpy()
    want = np.asarray(jops.flash_attention(qm, km, vm,
                                           kv_offsets=jnp.asarray(off)))
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# flash decode (tests/test_serving.py:35 grid, fused RoPE, per-row pos)
# ---------------------------------------------------------------------------

DECODE_CASES = [
    (2, 4, 4, 257, 64, None, False, None),       # MHA, ragged S
    (2, 4, 2, 100, 64, None, False, None),       # GQA
    (2, 8, 2, 333, 64, 48, False, None),         # window on a full cache
    (2, 4, 2, 16, 64, 16, True, None),           # SWA ring buffer
    (3, 4, 1, 64, 32, None, False, (0, 5, 63)),  # left-padded prompts
    (2, 4, 2, 16, 64, 16, True, (0, 3)),         # ring + ragged
]


def _decode_inputs(B, H, KV, S, hd, seed):
    rng = np.random.RandomState(seed)
    return (_randn(rng, B, H, hd), _randn(rng, B, KV, S, hd),
            _randn(rng, B, KV, S, hd))


@pytest.mark.parametrize("B,H,KV,S,hd,window,ring,offs", DECODE_CASES)
def test_flash_decode_matches_reference(B, H, KV, S, hd, window, ring, offs):
    q, k, v = _decode_inputs(B, H, KV, S, hd, S + hd)
    off = None if offs is None else np.array(offs, np.int32)
    toff = None if off is None else torch.tensor(off)
    joff = None if off is None else jnp.asarray(off)
    lo = 0 if offs is None else max(offs)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    for pos in sorted({lo, max(lo, S // 2), S - 1,
                       (S + 7) if ring else S - 1}):
        got = FD.flash_decode(tq, tk, tv, pos, window=window, ring=ring,
                              offsets=toff)
        for want in (jref.flash_decode_ref(q, k, v, jnp.int32(pos),
                                           window=window, ring=ring,
                                           offsets=joff),
                     flash_decode_pallas(q, k, v, jnp.int32(pos),
                                         window=window, ring=ring,
                                         offsets=joff, interpret=True)):
            _close(got, want, 3e-6, rtol=1e-5)
        # fused query RoPE, against the Pallas kernel's own rotation
        got = FD.flash_decode(tq, tk, tv, pos, window=window, ring=ring,
                              offsets=toff, rope_theta=1e4)
        want = flash_decode_pallas(q, k, v, jnp.int32(pos), window=window,
                                   ring=ring, offsets=joff, rope_theta=1e4,
                                   interpret=True)
        _close(got, want, 3e-6, rtol=1e-5)


def test_flash_decode_per_row_pos_and_adapter():
    """Per-row (B,) positions with offsets and RoPE, through the model
    adapter (B, 1, H, hd), against the JAX package's off-TPU lowering."""
    B, H, KV, S, hd = 3, 8, 2, 70, 64
    q, k, v = _decode_inputs(B, H, KV, S, hd, 11)
    pos = np.array([9, 69, 40], np.int32)
    off = np.array([2, 0, 40], np.int32)
    got = tops.flash_decode(torch.tensor(q[:, None]), torch.tensor(k),
                            torch.tensor(v), torch.tensor(pos),
                            offsets=torch.tensor(off), rope_theta=1e6)
    want = jops.flash_decode(q[:, None], k, v, jnp.asarray(pos),
                             offsets=jnp.asarray(off), rope_theta=1e6)
    _close(got, want, 3e-6, rtol=1e-5)
    blk = flash_decode_blockwise(q, k, v, jnp.asarray(pos),
                                 offsets=jnp.asarray(off), rope_theta=1e6,
                                 block_k=32)
    _close(got[:, 0], blk, 3e-6, rtol=1e-5)


def test_row_adapters_match_reference_ops():
    """``ops.rmsnorm_residual`` / ``ops.swiglu`` over (B, T, d) against the
    JAX package's ops (their off-TPU lowerings)."""
    rng = np.random.RandomState(4)
    x, r = _randn(rng, 2, 5, 128), _randn(rng, 2, 5, 128)
    scale = np.linspace(0.5, 1.5, 128, dtype=np.float32)
    y, s = tops.rmsnorm_residual(*map(torch.tensor, (x, r, scale)))
    yr, sr = jops.rmsnorm_residual(x, r, scale)
    _close(y, yr, 1e-5)
    _close(s, sr, 1e-5)
    wg, wu = _randn(rng, 128, 256, scale=0.1), _randn(rng, 128, 256,
                                                       scale=0.1)
    h = tops.swiglu(*map(torch.tensor, (x, wg, wu)))
    assert h.shape == (2, 5, 256)
    _close(h, jops.swiglu(x, wg, wu), 1e-5)


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    for mod in (FA, FD, FN, SW):
        mod.reset_launches()
    rng = np.random.RandomState(0)
    x = torch.tensor(_randn(rng, 4, 128))
    FN.rmsnorm_residual(x, x, torch.ones(128))
    SW.swiglu(x, torch.tensor(_randn(rng, 128, 64)),
              torch.tensor(_randn(rng, 128, 64)))
    q = torch.tensor(_randn(rng, 1, 2, 8, 32))
    FA.flash_attention_fwd(q, q, q)
    FD.flash_decode(q[:, :, 0], q, q, 3)
    for mod in (FA, FD, FN, SW):
        assert set(mod.launches.values()) == {0}, mod.__name__
