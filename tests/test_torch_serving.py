"""The port's serving path held to the JAX package on the CPU: reduced
qwen3-1.7b in f32 with the reference's parameters carried across by
``convert.lm_to_torch``. Prefill and decode logits and caches agree within
1e-4 (caches on real slots: a left-pad slot holds K/V of padding in both,
but the port's pad query rows are defined as 0), and greedy ``generate``
tokens are equal, with and without the kernels' structure, for plain and
left-padded ragged batches. The JAX side runs ``use_kernels=True`` as its
own tests do on the CPU (flash prefill in interpret mode, the blockwise
decode lowering)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.registry import get_config as jget_config
from repro.models import transformer as JT
from repro.serving import generate as jgenerate
from repro.serving import prefill_fused as jprefill_fused
from repro_torch import convert
from repro_torch.configs import LayerSpec, get_config
from repro_torch.models import transformer as TT
from repro_torch.serving import generate, prefill_fused, sample_tokens

TOL = 1e-4
CPU = "cpu"


def _cfgs(**overrides):
    j = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                            dtype="float32", **overrides)
    t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                            dtype="float32", **overrides)
    return j, t


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _ragged(P, lens, vocab, seed):
    full = _tokens((len(lens), P), vocab, seed)
    return np.where(np.arange(P)[None] >= P - np.array(lens)[:, None], full,
                    0).astype(np.int32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_caches(tcache, jcache, offsets, head_major):
    """Every layer's K and V, on each row's real slots."""
    got = jax.tree.leaves(convert.lm_to_numpy(tcache))
    want = jax.tree.leaves(jax.device_get(jcache))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if head_major:                # (R, B, KV, S, hd) -> (R, B, S, KV, hd)
            g, w = g.transpose(0, 1, 3, 2, 4), w.transpose(0, 1, 3, 2, 4)
        if offsets is not None:
            real = np.arange(g.shape[2])[None, :] >= np.asarray(offsets)[:,
                                                                         None]
            g, w = g[:, real], w[:, real]
        _close(g, w)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def test_lm_tree_round_trip_is_identity(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["stack"]["body"][0]) == tcfg.body_repeats
    assert tp["stack"]["body"][0][0]["mixer"]["wq"].shape == (256, 256)
    back = convert.lm_to_numpy(tp)
    ref = jax.device_get(jp)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_lm_conversion_keeps_4d_leaves_as_they_are():
    """A stacked 4-D LM leaf (e.g. a (R, kv, S, hd) cache) keeps its layout;
    ``to_torch`` would read it as an HWIO convolution weight."""
    _, tcfg = _cfgs()
    a = np.arange(2 * 3 * 4 * 5 * 6, dtype=np.float32).reshape(2, 3, 4, 5, 6)
    tree = {"stack": {"head": [], "body": [{"kh": a}], "tail": []},
            "w4": a[0]}
    t = convert.lm_to_torch(tree, tcfg, CPU)
    np.testing.assert_array_equal(t["stack"]["body"][0][1]["kh"].numpy(),
                                  a[1])
    np.testing.assert_array_equal(t["w4"].numpy(), a[0])
    back = convert.lm_to_numpy(t)
    np.testing.assert_array_equal(back["stack"]["body"][0]["kh"], a)
    bf = convert.lm_to_torch({"x": jnp.ones((2, 2), jnp.bfloat16)}, tcfg,
                             CPU)["x"]
    assert bf.dtype == torch.bfloat16 and float(bf.sum()) == 4.0


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

PREFILL_CASES = [(True, None), (False, None), (True, (12, 5)),
                 (False, (12, 5))]


@pytest.mark.parametrize("use_kernels,lens", PREFILL_CASES)
def test_prefill_and_decode_match_reference(model, use_kernels, lens):
    """Fused prefill, then two decode steps (an int position, then per-row
    positions), logits and caches within 1e-4."""
    jcfg, tcfg, jp, tp = model
    P, total = 12, 16
    toks = (_tokens((2, P), tcfg.vocab_size, 1) if lens is None
            else _ragged(P, lens, tcfg.vocab_size, 1))
    off = None if lens is None else (P - np.array(lens)).astype(np.int32)
    joff = None if off is None else jnp.asarray(off)
    toff = None if off is None else torch.tensor(off)
    layout = "head" if use_kernels else "seq"
    jc = JT.init_cache(jcfg, 2, total, dtype=jnp.float32, layout=layout)
    tc = TT.init_cache(tcfg, 2, total, layout=layout, device=CPU)
    jl, jc = JT.prefill_forward(jp, jcfg, jnp.asarray(toks), jc,
                                use_kernels=use_kernels, offsets=joff)
    tl, tc = TT.prefill_forward(tp, tcfg, torch.tensor(toks), tc,
                                use_kernels=use_kernels, offsets=toff)
    _close(tl, jl)
    _close_caches(tc, jc, off, use_kernels)
    nxt = _tokens((2, 1), tcfg.vocab_size, 2)
    for pos in (P, np.array([P + 1, P + 1], np.int32)):
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = pos if isinstance(pos, int) else torch.tensor(pos)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(nxt), jc, jpos,
                                use_kernels=use_kernels, offsets=joff)
        tl, tc = TT.decode_step(tp, tcfg, torch.tensor(nxt), tc, tpos,
                                use_kernels=use_kernels, offsets=toff)
        _close(tl, jl)
    _close_caches(tc, jc, off, use_kernels)


GEN_CASES = [(True, False), (False, False), (True, True), (False, True)]


@pytest.mark.parametrize("use_kernels,ragged", GEN_CASES)
def test_generate_matches_reference(model, use_kernels, ragged):
    """Greedy tokens equal to ``repro.serving.generate`` (mirrors
    test_generate_kernels_equals_nonkernel / test_ragged_matches_unpadded)."""
    jcfg, tcfg, jp, tp = model
    if ragged:
        P, lens = 20, (4, 20, 13)
        prompts = _ragged(P, lens, tcfg.vocab_size, 3)
        kw = dict(max_new_tokens=6)
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts),
                         prompt_lens=jnp.array(lens, jnp.int32),
                         use_kernels=use_kernels, **kw)
        tout = generate(tp, tcfg, prompts, prompt_lens=lens,
                        use_kernels=use_kernels, device=CPU, **kw)
    else:
        prompts = _tokens((3, 10), tcfg.vocab_size, 1)
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=12,
                         use_kernels=use_kernels)
        tout = generate(tp, tcfg, prompts, max_new_tokens=12,
                        use_kernels=use_kernels, device=CPU)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_ragged_matches_unpadded(model, use_kernels):
    """Each left-padded row continues exactly as it does alone unpadded."""
    _, tcfg, _, tp = model
    P, lens = 20, (4, 20, 13)
    padded = _ragged(P, lens, tcfg.vocab_size, 1)
    rag = generate(tp, tcfg, padded, max_new_tokens=6, prompt_lens=lens,
                   use_kernels=use_kernels, device=CPU)
    for b, L in enumerate(lens):
        solo = generate(tp, tcfg, padded[b:b + 1, P - L:], max_new_tokens=6,
                        use_kernels=use_kernels, device=CPU)
        np.testing.assert_array_equal(rag[b, P:].numpy(), solo[0, L:].numpy())


def test_sliding_window_ring_matches_reference():
    """A sliding-window ("swa") variant: P = 20 > the 16-slot ring, so the
    prefill's ring wrap and the ring decode are on the path."""
    jcfg, tcfg = _cfgs(body_pattern=(LayerSpec(mixer="swa", ff="dense"),))
    from repro.configs.base import LayerSpec as JLayerSpec
    jcfg = dataclasses.replace(
        jcfg, body_pattern=(JLayerSpec(mixer="swa", ff="dense"),))
    jp = JT.init_params(jax.random.PRNGKey(5), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    P, lens = 20, (20, 9)
    prompts = _ragged(P, lens, tcfg.vocab_size, 6)
    for use_kernels in (True, False):
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=5,
                         prompt_lens=jnp.array(lens, jnp.int32),
                         use_kernels=use_kernels)
        tout = generate(tp, tcfg, prompts, max_new_tokens=5, prompt_lens=lens,
                        use_kernels=use_kernels, device=CPU)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


# ---------------------------------------------------------------------------
# generate's checks and sampling
# ---------------------------------------------------------------------------


def test_generate_error_cases(model):
    _, tcfg, _, tp = model
    prompts = torch.tensor(_tokens((2, 8), tcfg.vocab_size, 1))
    for max_len in (0, 10):
        with pytest.raises(ValueError, match="cache depth"):
            generate(tp, tcfg, prompts, max_new_tokens=4, max_len=max_len,
                     device=CPU)
    for lens in ((0, 8), (3, 9), (1, 2, 3)):
        with pytest.raises(ValueError, match="prompt_lens"):
            generate(tp, tcfg, prompts, max_new_tokens=4, prompt_lens=lens,
                     device=CPU)
    with pytest.raises(ValueError, match="rng"):
        generate(tp, tcfg, prompts, max_new_tokens=4, temperature=0.5,
                 device=CPU)
    out0 = generate(tp, tcfg, prompts, max_new_tokens=0, device=CPU)
    assert torch.equal(out0, prompts)
    out1 = generate(tp, tcfg, prompts, max_new_tokens=1, max_len=12,
                    device=CPU)
    cache = TT.init_cache(tcfg, 2, 9, device=CPU)
    last, _ = prefill_fused(tp, tcfg, prompts, cache)
    assert out1.shape == (2, 9)
    assert torch.equal(out1[:, 8], sample_tokens(tcfg, last).to(out1.dtype))


def test_sampling_is_seeded_in_vocab_and_greedy_at_zero(model):
    _, tcfg, _, tp = model
    prompts = _tokens((2, 8), tcfg.vocab_size, 1)
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=16, device=CPU)
    gen = lambda s: torch.Generator().manual_seed(s)   # noqa: E731
    o1 = generate(tp, tcfg, prompts, generator=gen(3), **kw)
    o2 = generate(tp, tcfg, prompts, generator=gen(3), **kw)
    o3 = generate(tp, tcfg, prompts, generator=gen(4), **kw)
    assert torch.equal(o1, o2)
    assert not torch.equal(o1, o3)
    assert (o1 < tcfg.vocab_size).all()
    greedy = generate(tp, tcfg, prompts, max_new_tokens=8, device=CPU)
    t0 = generate(tp, tcfg, prompts, max_new_tokens=8, temperature=0.0,
                  generator=gen(7), device=CPU)
    assert torch.equal(greedy, t0)


def test_top_k_is_clamped_to_the_vocab():
    _, tcfg = _cfgs(vocab_size=500)
    assert tcfg.padded_vocab == 512
    logits = torch.tensor(np.random.RandomState(0).randn(4, 512)
                          .astype(np.float32))
    want = sample_tokens(tcfg, logits, temperature=0.7,
                         generator=torch.Generator().manual_seed(1))
    for k in (500, 537, 10_000):
        got = sample_tokens(tcfg, logits, temperature=0.7, top_k=k,
                            generator=torch.Generator().manual_seed(1))
        assert torch.equal(got, want) and (got < 500).all()


def test_padded_vocab_is_never_sampled():
    """With padded_vocab != vocab_size, boosted padded rows of the tied
    embedding would win an unmasked argmax."""
    jcfg, tcfg = _cfgs(vocab_size=500)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp["embed"] = jp["embed"].at[500:].set(5.0)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    prompts = _tokens((2, 6), 500, 1)
    out = generate(tp, tcfg, prompts, max_new_tokens=5, device=CPU)
    assert (out < 500).all()
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jgenerate(jp, jcfg, jnp.asarray(prompts),
                                          max_new_tokens=5)))
    cache = JT.init_cache(jcfg, 2, 6, dtype=jnp.float32)
    jl, _ = jprefill_fused(jp, jcfg, jnp.asarray(prompts), cache)
    tl, _ = prefill_fused(tp, tcfg, torch.tensor(prompts),
                          TT.init_cache(tcfg, 2, 6, device=CPU))
    _close(tl, jl)
