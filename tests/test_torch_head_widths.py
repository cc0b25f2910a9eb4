"""Head widths 112 (kimi-k2) and 120 (h2o-danube-3-4b) held to the JAX
package on the CPU, in f32.

- The plain versions of the attention kernels, which the wrappers take for
  a CPU tensor, at both widths against the Pallas kernels in interpret
  mode, as tests/test_kernels.py runs them: the ragged forward with
  ``kv_offsets`` and a window (B9), the RoPE forward (B7) and both
  backwards (B8), GQA throughout, at 2e-5 and 5e-4; the decode (B12) over
  a ring with a window, offsets and RoPE, and the paged decode (B13) over a
  shuffled pool, f32 and int8, at atol 3e-6, rtol 1e-5.
- Reduced h2o-danube-3-4b and kimi-k2-1t-a32b with ``head_dim`` replaced by
  120 and 112 on both sides (the same ``dataclasses.replace`` of the same
  reduced config) on transplanted parameters: prefill logits and a decode
  step (1e-4), ``lm_loss`` (1e-5) and the gradients of every leaf (1e-4),
  through the kernels' path (their plain versions here).

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
to these plain versions at both widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import (flash_attention_backward_pallas,
                                           flash_attention_pallas,
                                           flash_attention_rope_backward_pallas,
                                           flash_attention_rope_pallas)
from repro.kernels.flash_decode import (flash_decode_paged_pallas,
                                        flash_decode_pallas)
from repro.models import transformer as JT
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.models import transformer as TT

CPU = "cpu"
WIDTHS = (112, 120)
ATOL, RTOL = 3e-6, 1e-5      # the reference's decode tests
LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-4


def _close(got, want, tol, rtol=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a))
            for a in arrays]


# ---------------------------------------------------------------------------
# the attention kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", WIDTHS)
def test_flash_attention_with_offsets_and_window(hd):
    """B9: GQA 2:1, T = 40, a window of 13, left pads (0, 7)."""
    B, H, KV, T = 2, 4, 2, 40
    rng = np.random.RandomState(hd)
    q, k, v = _randn(rng, B, H, T, hd), _randn(rng, B, KV, T, hd), \
        _randn(rng, B, KV, T, hd)
    off = np.array([0, 7], np.int32)
    o, lse = FA.flash_attention_fwd(*_t(q, k, v), window=13,
                                    kv_offsets=torch.tensor(off),
                                    return_lse=True)
    ok, lk = flash_attention_pallas(q, k, v, causal=True, window=13,
                                    block_q=32, block_k=32,
                                    kv_offsets=jnp.asarray(off),
                                    return_residuals=True, interpret=True)
    rows = np.broadcast_to(np.arange(T)[None, None] >= off[:, None, None],
                           (B, H, T))
    _close(o.numpy()[rows], np.asarray(ok)[rows], 2e-5)
    _close(lse.numpy()[rows], np.asarray(lk)[rows], 2e-5)


def _rope_inputs(hd, seed):
    B, H, KV, T = 2, 4, 1, 33
    rng = np.random.RandomState(seed)
    q, do = _randn(rng, B, H, T, hd), _randn(rng, B, H, T, hd)
    k, v = _randn(rng, B, KV, T, hd), _randn(rng, B, KV, T, hd)
    pos = (np.arange(T)[None] + 3 * np.arange(B)[:, None]).astype(np.float32)
    return q, k, v, pos, do


@pytest.mark.parametrize("hd", WIDTHS)
def test_flash_attention_rope_and_backward(hd):
    """B7 (o, lse 2e-5) and B8 through RoPE and without it (5e-4), GQA
    4:1, T = 33 (off the kernels' 32-row blocks), a window of 13."""
    window = 13
    q, k, v, pos, do = _rope_inputs(hd, hd)
    o, lse = FA.flash_attention_rope_fwd(*_t(q, k, v, pos), theta=1e4,
                                         window=window, return_lse=True)
    ok, lk = flash_attention_rope_pallas(q, k, v, pos, theta=1e4,
                                         causal=True, window=window,
                                         block_q=32, block_k=32,
                                         return_residuals=True,
                                         interpret=True)
    _close(o, ok, 2e-5)
    _close(lse, lk, 2e-5)
    got = FA.flash_attention_rope_backward(*_t(q, k, v, pos, ok, lk, do),
                                           theta=1e4, window=window)
    kern = flash_attention_rope_backward_pallas(
        q, k, v, pos, ok, lk, do, theta=1e4, causal=True, window=window,
        block_q=32, block_k=32, interpret=True)
    for g, w in zip(got, kern):
        _close(g, w, 5e-4)
    o2, l2 = flash_attention_pallas(q, k, v, causal=True, window=window,
                                    block_q=32, block_k=32,
                                    return_residuals=True, interpret=True)
    got = FA.flash_attention_backward(*_t(q, k, v, o2, l2, do),
                                      window=window)
    kern = flash_attention_backward_pallas(q, k, v, o2, l2, do, causal=True,
                                           window=window, block_q=32,
                                           block_k=32, fuse_dq=False,
                                           interpret=True)
    for g, w in zip(got, kern):
        _close(g, w, 5e-4)


@pytest.mark.parametrize("hd", WIDTHS)
def test_flash_decode_ring_window_offsets_rope(hd):
    """B12 over a ring of 16 slots with a window of 16, ragged offsets and
    the query's RoPE, at positions before and past the wrap."""
    B, H, KV, S = 2, 4, 2, 16
    rng = np.random.RandomState(hd)
    q, k, v = _randn(rng, B, H, hd), _randn(rng, B, KV, S, hd), \
        _randn(rng, B, KV, S, hd)
    off = np.array([0, 3], np.int32)
    for pos in (9, 23):
        got = FD.flash_decode(*_t(q, k, v), pos, window=16, ring=True,
                              offsets=torch.tensor(off), rope_theta=1e4)
        want = flash_decode_pallas(q, k, v, jnp.int32(pos), window=16,
                                   ring=True, offsets=jnp.asarray(off),
                                   rope_theta=1e4, interpret=True)
        _close(got, want, ATOL, RTOL)


def _paged(k, v, ps, seed):
    """(B, KV, S, hd) K/V scattered into a pool behind a shuffled table,
    page 0 the trash page."""
    B, KV, S, hd = k.shape
    NB = S // ps
    pt = np.random.RandomState(seed).permutation(
        np.arange(1, 1 + B * NB)).astype(np.int32).reshape(B, NB)

    def pool(x):
        p = np.zeros((1 + B * NB, KV, ps, hd), x.dtype)
        p[pt.reshape(-1)] = x.reshape(B, KV, NB, ps, hd).transpose(
            0, 2, 1, 3, 4).reshape(B * NB, KV, ps, hd)
        return p

    return pool(k), pool(v), pt


def _int8(p):
    """The reference tests' per-slot int8 rule."""
    sc = jnp.maximum(jnp.abs(p).max(axis=-1), 1e-8) / 127.0
    q = jnp.clip(jnp.round(p / sc[..., None]), -127, 127).astype(jnp.int8)
    return np.asarray(q), np.asarray(sc, np.float32)


@pytest.mark.parametrize("hd", WIDTHS)
@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_paged(hd, int8):
    """B13, GQA 4:1, pages of 16 through a shuffled table, a window of 24
    and ragged offsets, an f32 pool and an int8 one (rows of 120 bytes at
    hd 120)."""
    B, H, KV, ps, NB = 2, 8, 2, 16, 3
    rng = np.random.RandomState(hd + int8)
    q = _randn(rng, B, H, hd)
    k, v = _randn(rng, B, KV, NB * ps, hd), _randn(rng, B, KV, NB * ps, hd)
    kp, vp, pt = _paged(k, v, ps, hd)
    sc = {}
    if int8:
        (kp, ks), (vp, vs) = _int8(kp), _int8(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    pos, off = np.array([40, 29], np.int32), np.array([0, 5], np.int32)
    got = FD.flash_decode_paged(*_t(q, kp, vp, pt, pos), window=24,
                                offsets=torch.tensor(off),
                                **{n: torch.tensor(a) for n, a in sc.items()})
    want = flash_decode_paged_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, pos)), window=24,
        offsets=jnp.asarray(off), interpret=True,
        **{n: jnp.asarray(a) for n, a in sc.items()})
    _close(got, want, ATOL, RTOL)
    oracle = jref.flash_decode_paged_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, pos)), window=24,
        offsets=jnp.asarray(off), **{n: jnp.asarray(a)
                                     for n, a in sc.items()})
    _close(got, oracle, ATOL, RTOL)


# ---------------------------------------------------------------------------
# reduced models at the published head widths
# ---------------------------------------------------------------------------

MODELS = [("h2o-danube-3-4b", 120), ("kimi-k2-1t-a32b", 112)]


def _model(arch, hd):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                               head_dim=hd)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               head_dim=hd)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch,hd", MODELS)
def test_reduced_model_at_the_published_width(arch, hd):
    """Prefill over 24 tokens (past h2o's reduced window of 16) and a
    decode step through the kernels' path (a head-major cache), then
    ``lm_loss`` and every leaf's gradient."""
    jcfg, tcfg, jp, tp = _model(arch, hd)
    assert tcfg.head_dim == hd and tcfg.n_heads * hd != tcfg.d_model
    P = 24
    toks, nxt = _tokens((2, P), tcfg.vocab_size, 1), \
        _tokens((2, 1), tcfg.vocab_size, 2)
    jc = JT.init_cache(jcfg, 2, P + 1, dtype=jnp.float32, layout="seq")
    jl, jc = jax.jit(lambda p, t, c: JT.prefill_forward(p, jcfg, t, c))(
        jp, jnp.asarray(toks), jc)
    jd, _ = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c, P))(
        jp, jnp.asarray(nxt), jc)
    tc = TT.init_cache(tcfg, 2, P + 1, device=CPU, layout="head")
    tl, tc = TT.prefill_forward(tp, tcfg, torch.tensor(toks), tc,
                                use_kernels=True)
    _close(tl, jl, LOGIT_TOL)
    td, _ = TT.decode_step(tp, tcfg, torch.tensor(nxt), tc, P,
                           use_kernels=True)
    _close(td, jd, LOGIT_TOL)

    batch = _tokens((2, 32), tcfg.vocab_size, 3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(batch)}),
        has_aux=True))(jp)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, _ = TT.lm_loss(tree.unflatten(tp, leaves), tcfg,
                         {"tokens": torch.tensor(batch)}, use_kernels=True)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss, LOSS_TOL)
    got = tree.leaves(convert.lm_to_numpy(tree.unflatten(tp, list(grads))))
    want = jax.tree.leaves(jax.device_get(jgrads))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, GRAD_TOL)
