"""The port's continuous-batching slice held to the JAX package on the CPU:
the paged decode's plain version against the Pallas kernel in interpret
mode, its blockwise lowering and its oracle (atol 3e-6, rtol 1e-5, as the
reference's paged tests hold them); the int8 quantizer; the paged and int8
caches and the paged decode step on transplanted caches (1e-4); the
ContinuousEngine's completions against ``repro.serving.ContinuousEngine``
and against the port's own solo ``generate`` on reduced qwen3-1.7b in f32
with transplanted parameters; the observability sinks; the token-at-a-time
prefill. Inputs are made with numpy from a seed and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.flash_decode import (flash_decode_paged_blockwise,
                                        flash_decode_paged_pallas)
from repro.models import transformer as JT
from repro.obs import Observability as JObservability
from repro.serving import ContinuousEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import generate as jgenerate
from repro.serving import poisson_trace as jpoisson_trace
from repro.serving import run_static_trace as jrun_static_trace
from repro.serving.engine import _slot_scales as j_slot_scales
from repro.serving.engine import _write_pt as j_write_pt
from repro_torch import convert
from repro_torch.configs import LayerSpec, get_config
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as TT
from repro_torch.obs import Observability
from repro_torch.serving import (ContinuousEngine, Request, generate,
                                 poisson_trace, prefill, prefill_fused,
                                 run_static_trace)

CPU = "cpu"
ATOL, RTOL = 3e-6, 1e-5          # tests/test_serving_continuous.py
TOL = 1e-4                       # logits and caches, as test_torch_serving


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def _paged_from_contiguous(k, v, ps, seed=0):
    """numpy (B, KV, S, hd) K/V scattered into a page pool with a shuffled
    block table (page 0 kept as the trash page)."""
    B, KV, S, hd = k.shape
    NB = S // ps
    pt = np.random.RandomState(seed).permutation(
        np.arange(1, 1 + B * NB)).astype(np.int32).reshape(B, NB)

    def pool(x):
        blocks = x.reshape(B, KV, NB, ps, hd).transpose(0, 2, 1, 3, 4)
        p = np.zeros((1 + B * NB, KV, ps, hd), x.dtype)
        p[pt.reshape(-1)] = blocks.reshape(B * NB, KV, ps, hd)
        return p

    return pool(k), pool(v), pt


def _qkv(B, H, KV, S, hd, seed):
    r = np.random.RandomState(seed)
    return tuple(r.randn(*s).astype(np.float32)
                 for s in ((B, H, hd), (B, KV, S, hd), (B, KV, S, hd)))


def _quantize_pool(kp):
    """The reference tests' per-slot int8 rule (test_fused_kernels.py)."""
    sc = jnp.maximum(jnp.abs(kp).max(axis=-1), 1e-8) / 127.0
    q = jnp.clip(jnp.round(kp / sc[..., None]), -127, 127).astype(jnp.int8)
    return np.asarray(q), np.asarray(sc, np.float32)


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a))
            for a in arrays]


# ---------------------------------------------------------------------------
# the plain paged decode against the Pallas kernel, its lowering, its oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,NB,ps,hd,window,offs", [
    (2, 4, 4, 4, 16, 64, None, None),        # MHA causal
    (2, 4, 2, 4, 16, 64, None, None),        # GQA
    (2, 8, 2, 4, 16, 64, 24, None),          # window mask over pages
    (3, 4, 1, 2, 32, 32, None, (0, 5, 40)),  # ragged left padding
])
def test_paged_plain_matches_reference(B, H, KV, NB, ps, hd, window, offs):
    """tests/test_serving_continuous.py:54-58: shuffled block table, per-row
    positions at different depths (one mid-page)."""
    S = NB * ps
    q, k, v = _qkv(B, H, KV, S, hd, B + NB)
    off = None if offs is None else np.array(offs, np.int32)
    lo = 0 if offs is None else max(offs)
    pos = np.array([max(lo, S - 1 - 7 * i) for i in range(B)], np.int32)
    kp, vp, pt = _paged_from_contiguous(k, v, ps)
    got = FD.flash_decode_paged(*_t(q, kp, vp, pt, pos), window=window,
                                offsets=_t(off)[0])
    joff = None if off is None else jnp.asarray(off)
    paged = _j(q, kp, vp, pt, pos)
    for name, want in [
        ("oracle", jref.flash_decode_paged_ref(*paged, window=window,
                                               offsets=joff)),
        ("contiguous oracle", jref.flash_decode_ref(*_j(q, k, v, pos),
                                                    window=window,
                                                    offsets=joff)),
        ("pallas", flash_decode_paged_pallas(*paged, window=window,
                                             offsets=joff, interpret=True)),
        ("blockwise", flash_decode_paged_blockwise(*paged, window=window,
                                                   offsets=joff)),
    ]:
        _close(got, want, msg=name)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_plain_trash_pages(int8):
    """Table entries past pos on the trash page 0 are an exact no-op; an
    all-trash row stays finite and equals the reference's (it reads page 0,
    zeros in codes and scales)."""
    B, H, KV, NB, ps, hd = 2, 4, 2, 4, 16, 64
    q, k, v = _qkv(B, H, KV, NB * ps, hd, 1)
    pos = np.array([ps + 3, 2 * ps - 1], np.int32)
    kp, vp, pt = _paged_from_contiguous(k, v, ps)
    sc = {}
    if int8:
        (kp, ks), (vp, vs) = _quantize_pool(kp), _quantize_pool(vp)
        sc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tsc = {n: torch.tensor(np.asarray(a)) for n, a in sc.items()}
    full = tref.flash_decode_paged_ref(*_t(q, kp, vp, pt, pos), **tsc)
    trashed = pt.copy()
    trashed[:, 2:] = 0
    got = tref.flash_decode_paged_ref(*_t(q, kp, vp, trashed, pos), **tsc)
    assert torch.equal(got, full)
    _close(got, flash_decode_paged_pallas(*_j(q, kp, vp, trashed, pos),
                                          interpret=True, **sc))
    dead_pt = np.zeros_like(pt)
    dead = tref.flash_decode_paged_ref(*_t(q, kp, vp, dead_pt, pos), **tsc)
    assert torch.isfinite(dead).all()
    _close(dead, flash_decode_paged_blockwise(*_j(q, kp, vp, dead_pt, pos),
                                              **sc))


def test_paged_plain_row_that_sees_no_slot_is_zero():
    """offsets past pos: no visible slot, the row is the mean of V over its
    NB * ps logical slots (the softmax of equal masked logits), as the
    reference's oracle gives it."""
    q, k, v = _qkv(2, 4, 2, 32, 32, 2)
    kp, vp, pt = _paged_from_contiguous(k, v, 16)
    pos, off = np.array([10, 20], np.int32), np.array([11, 0], np.int32)
    out = tref.flash_decode_paged_ref(*_t(q, kp, vp, pt, pos),
                                      offsets=torch.tensor(off))
    _close(out, jref.flash_decode_paged_ref(*_j(q, kp, vp, pt, pos),
                                            offsets=jnp.asarray(off)))
    _close(out[0], np.repeat(v[0].mean(axis=1), 2, axis=0))
    assert out[1].abs().sum() > 0


@pytest.mark.parametrize("window,theta", [(None, None), (24, None),
                                          (None, 1e4), (24, 1e6)])
def test_paged_plain_int8_matches_reference(window, theta):
    """tests/test_fused_kernels.py:455-515: in-kernel dequant (pallas,
    blockwise) and the port's plain version against the oracle that
    materialises the dequantized pool, with window and fused RoPE."""
    B, H, KV, NB, ps, hd = 2, 4, 2, 4, 16, 64
    S = NB * ps
    q, k, v = _qkv(B, H, KV, S, hd, 47)
    pos = np.array([S - 1, S // 2 + 3], np.int32)
    kp, vp, pt = _paged_from_contiguous(k, v, ps)
    (kq, ksc), (vq, vsc) = _quantize_pool(kp), _quantize_pool(vp)
    sc = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    qo = q if theta is None else jref.rope_ref(
        jnp.asarray(q)[:, :, None], jnp.asarray(pos)[:, None], theta)[:, :, 0]
    want = jref.flash_decode_paged_ref(*_j(qo, kq, vq, pt, pos),
                                       window=window, **sc)
    got = FD.flash_decode_paged(
        *_t(q, kq, vq, pt, pos), window=window, rope_theta=theta,
        k_scale=torch.tensor(ksc), v_scale=torch.tensor(vsc))
    _close(got, want, msg="oracle")
    for name, fn in (("pallas", lambda *a, **kw: flash_decode_paged_pallas(
                          *a, interpret=True, **kw)),
                     ("blockwise", flash_decode_paged_blockwise)):
        _close(got, fn(*_j(q, kq, vq, pt, pos), window=window,
                       rope_theta=theta, **sc), msg=name)


# ---------------------------------------------------------------------------
# the per-slot int8 quantizer
# ---------------------------------------------------------------------------


def test_quantize_slots_equals_the_reference_rule():
    """Codes and scales equal the reference's rule exactly, .5 ties
    included (both round half to even); the round trip is within scale/2
    and an all-zero slot survives the clamped scale."""
    r = np.random.RandomState(43)
    x = (r.randn(6, 2, 16, 64)
         * np.exp(r.randn(6, 1, 1, 1))).astype(np.float32)
    x[0] = 0.0
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                    np.float32)                  # scale 1: x / scale = x
    x[1, 0, 0, :8] = ties
    x[1, 0, 0, 8:] = 0.25
    codes, scale = tref.quantize_slots(torch.tensor(x))
    jcodes, jscale = _quantize_pool(x)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(j_slot_scales(jnp.asarray(x))))
    assert codes[1, 0, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    deq = codes.float() * scale[..., None]
    assert float((deq - torch.tensor(x)).abs().sub(
        scale[..., None] / 2).max()) <= 1e-6
    assert not deq[0].any()


# ---------------------------------------------------------------------------
# caches and the paged decode step
# ---------------------------------------------------------------------------


def _cfgs(**overrides):
    j = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                            dtype="float32", **overrides)
    t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                            dtype="float32", **overrides)
    return j, t


def _swa_cfgs():
    """Reduced qwen3 with an (attn, swa) body: the swa layers ride a paged
    cache on their head-major ring."""
    j, t = _cfgs(body_repeats=1)
    j = dataclasses.replace(j, body_pattern=(
        JLayerSpec(mixer="attn", ff="dense"),
        JLayerSpec(mixer="swa", ff="dense")))
    t = dataclasses.replace(t, body_pattern=(
        LayerSpec(mixer="attn", ff="dense"),
        LayerSpec(mixer="swa", ff="dense")))
    return j, t


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


@pytest.mark.parametrize("cfgs", [_cfgs, _swa_cfgs], ids=["attn", "swa"])
@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_paged_cache_has_the_reference_leaves(cfgs, cache_dtype):
    """Leaf names, shapes and dtypes of ``init_cache(layout="paged")`` equal
    the reference's; a swa layer keeps its ring; one block table tensor is
    shared by every layer."""
    jcfg, tcfg = cfgs()
    kw = dict(layout="paged", page_size=8, cache_dtype=cache_dtype)
    jc = JT.init_cache(jcfg, 3, 32, dtype=jnp.float32, **kw)
    tc = TT.init_cache(tcfg, 3, 32, device=CPU, **kw)
    got, want = _leaves(convert.lm_to_numpy(tc)), _leaves(jc)
    assert sorted(got) == sorted(want)
    for name in want:
        assert (got[name].shape, got[name].dtype) == \
            (want[name].shape, want[name].dtype), name
    assert any(n.endswith("['kp']") for n in got)
    assert any(n.endswith("['kh']") for n in got) == (cfgs is _swa_cfgs)
    tables = {id(c["attn"]["pt"]) for c in tc["body"][0]}
    assert len(tables) == 1


def test_cache_errors():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="requires layout='paged'"):
        TT.init_cache(tcfg, 2, 16, layout="head", cache_dtype="int8",
                      device=CPU)
    with pytest.raises(ValueError, match="unknown cache_dtype"):
        TT.init_cache(tcfg, 2, 16, layout="paged", cache_dtype="fp8",
                      device=CPU)


def test_paged_cache_tree_round_trips_through_the_converter():
    """int8 kp/vp, int32 pt and f32 ks/vs, stacked body leaves included,
    come back unchanged from ``lm_to_torch``/``lm_to_numpy``."""
    jcfg, tcfg = _cfgs()
    jc = JT.init_cache(jcfg, 2, 16, dtype=jnp.float32, layout="paged",
                       page_size=8, cache_dtype="int8")
    r = np.random.RandomState(3)

    def fill(path, leaf):
        a = np.asarray(leaf)
        if a.dtype == np.int8:
            return r.randint(-127, 128, a.shape).astype(np.int8)
        if a.dtype == np.int32:
            return r.randint(0, 5, a.shape).astype(np.int32)
        return r.rand(*a.shape).astype(a.dtype)

    ref = jax.tree_util.tree_map_with_path(fill, jax.device_get(jc))
    tc = convert.lm_to_torch(ref, tcfg, CPU)
    kp = tc["body"][0][1]["attn"]["kp"]
    assert kp.dtype == torch.int8 and kp.shape == (5, 2, 8, 64)
    back = convert.lm_to_numpy(tc)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_paged_decode_step_matches_reference(model, cache_dtype,
                                             use_kernels):
    """Per-row positions over a transplanted paged cache (a shuffled block
    table): logits and every leaf of the cache within 1e-4 after each of
    six steps."""
    jcfg, tcfg, jp, tp = model
    B, S, ps = 2, 16, 8
    NB = S // ps
    jc = JT.init_cache(jcfg, B, S, dtype=jnp.float32, layout="paged",
                       page_size=ps, total_pages=1 + B * NB,
                       cache_dtype=cache_dtype)
    table = np.random.RandomState(0).permutation(
        np.arange(1, 1 + B * NB)).astype(np.int32).reshape(B, NB)
    jc = j_write_pt(jc, jnp.asarray(table))
    tc = convert.lm_to_torch(jax.device_get(jc), tcfg, CPU)
    toks = np.random.RandomState(1).randint(0, tcfg.vocab_size, (B, 6))
    jstep = jax.jit(lambda p, tok, c, pos: JT.decode_step(
        p, jcfg, tok, c, pos, use_kernels=use_kernels))
    for t in range(6):
        pos = np.array([t, t + 5], np.int32)
        tok = toks[:, t:t + 1].astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = TT.decode_step(tp, tcfg, torch.tensor(tok), tc,
                                torch.tensor(pos), use_kernels=use_kernels)
        _close(tl, jl, TOL, TOL, msg=f"logits, step {t}")
    got, want = _leaves(convert.lm_to_numpy(tc)), _leaves(jc)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        _close(got[name], want[name], TOL, TOL, msg=name)


# ---------------------------------------------------------------------------
# ContinuousEngine
# ---------------------------------------------------------------------------


def _trace(cfg, n, seed=0, cls=Request):
    """tests/test_serving_continuous.py:162: staggered arrivals, prompts of
    4 or 8 tokens, 6 new tokens each."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = int(r.choice([4, 8]))
        prompt = r.randint(0, cfg.vocab_size, size=(L,)).astype("int32")
        out.append(cls(id=i, prompt=prompt, max_new_tokens=6,
                       arrival=0.9 * i))
    return out


def _tokens(comps):
    return {i: list(map(int, c.tokens)) for i, c in comps.items()}


ENGINE = dict(num_slots=2, max_len=16, page_size=8)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_matches_reference_and_solo(model, use_kernels):
    """Five requests through two slots (slot reuse, mid-flight admission):
    completions equal the reference engine's and the port's own solo
    ``generate``; the kernel path launches the paged decode once per layer
    per step (its plain version, on the CPU)."""
    jcfg, tcfg, jp, tp = model
    jcomps = JEngine(jp, jcfg, layout="paged", use_kernels=use_kernels,
                     **ENGINE).run(_trace(jcfg, 5, cls=JRequest))
    FD.reset_launches()
    eng = ContinuousEngine(tp, tcfg, layout="paged", use_kernels=use_kernels,
                           device=CPU, **ENGINE)
    comps = eng.run(_trace(tcfg, 5))
    assert sorted(comps) == list(range(5))
    assert _tokens(comps) == _tokens(jcomps)
    for r in _trace(tcfg, 5):
        solo = generate(tp, tcfg, np.asarray(r.prompt)[None],
                        max_new_tokens=6, max_len=16,
                        use_kernels=use_kernels, device=CPU)
        assert _tokens(comps)[r.id] == solo[0, len(r.prompt):].tolist()
    assert FD.launches["flash_decode_paged"] == 0     # CPU: plain version
    st = eng.stats()
    assert st["useful_tokens"] == 30           # 5 requests x 6 tokens
    # every lane decodes every step; each admission samples one token
    assert st["raw_tokens"] == 2 * st["steps"] + 5
    assert st["useful_tokens"] + st["dropped_tokens"] == st["raw_tokens"]


@pytest.mark.parametrize("layout,use_kernels", [("head", True),
                                                ("seq", False),
                                                ("seq", True)])
def test_contiguous_layouts_give_the_paged_completions(model, layout,
                                                       use_kernels):
    jcfg, tcfg, jp, tp = model
    reqs = _trace(tcfg, 4, seed=5)
    paged = ContinuousEngine(tp, tcfg, layout="paged", device=CPU,
                             use_kernels=use_kernels, **ENGINE).run(reqs)
    other = ContinuousEngine(tp, tcfg, layout=layout, device=CPU,
                             use_kernels=use_kernels, **ENGINE).run(reqs)
    assert _tokens(other) == _tokens(paged)
    jout = JEngine(jp, jcfg, layout=layout, **ENGINE).run(
        _trace(jcfg, 4, seed=5, cls=JRequest))
    assert _tokens(other) == _tokens(jout)


def test_eos_retirement_and_slot_reuse(model):
    """tests/test_serving_continuous.py:211: a row that emits eos_id retires
    early (its tokens end at the first EOS), its slot is re-admitted
    mid-flight, the newcomer equals its solo run, and every page returns
    to the free list."""
    _, tcfg, _, tp = model
    reqs = _trace(tcfg, 4, seed=3)
    solo = {r.id: generate(tp, tcfg, np.asarray(r.prompt)[None],
                           max_new_tokens=6, max_len=16, use_kernels=False,
                           device=CPU)[0, len(r.prompt):].tolist()
            for r in reqs}
    eos = solo[0][2]
    eng = ContinuousEngine(tp, tcfg, layout="paged", eos_id=eos,
                           use_kernels=False, device=CPU, **ENGINE)
    comps = eng.run(reqs)
    retired_early = False
    for r in reqs:
        want = solo[r.id]
        if eos in want:
            want = want[:want.index(eos) + 1]
            retired_early = retired_early or len(want) < r.max_new_tokens
        assert _tokens(comps)[r.id] == want, r.id
    assert retired_early
    assert not eng.active.any()
    assert sorted(eng.free_pages) == list(range(1, eng.total_pages))
    assert not eng.pt_host.any()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_int8_pool_gives_the_full_precision_tokens(model,
                                                          use_kernels):
    """tests/test_fused_kernels.py:560: the int8 pool's greedy tokens equal
    the full-precision pool's, and the reference int8 engine's."""
    jcfg, tcfg, jp, tp = model
    reqs = _trace(tcfg, 5)
    outs = {cd: _tokens(ContinuousEngine(
        tp, tcfg, layout="paged", cache_dtype=cd, use_kernels=use_kernels,
        device=CPU, **ENGINE).run(reqs)) for cd in (None, "int8")}
    assert outs[None] == outs["int8"]
    jout = JEngine(jp, jcfg, layout="paged", cache_dtype="int8",
                   use_kernels=use_kernels, **ENGINE).run(
        _trace(jcfg, 5, cls=JRequest))
    assert outs["int8"] == _tokens(jout)


def test_engine_with_a_sliding_window_layer_rides_its_ring():
    """An (attn, swa) body: the swa layer keeps its ring under "paged";
    completions equal the reference engine's and the solo runs."""
    jcfg, tcfg = _swa_cfgs()
    jcfg = dataclasses.replace(jcfg, sliding_window=8)
    tcfg = dataclasses.replace(tcfg, sliding_window=8)
    jp = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    reqs = _trace(tcfg, 5, seed=7)
    for uk in (False, True):
        eng = ContinuousEngine(tp, tcfg, layout="paged", use_kernels=uk,
                               device=CPU, **ENGINE)
        comps = eng.run(reqs)
        assert "kh" in eng.cache["body"][1][0]["attn"]
        jcomps = JEngine(jp, jcfg, layout="paged", use_kernels=uk,
                         **ENGINE).run(_trace(jcfg, 5, seed=7, cls=JRequest))
        assert _tokens(comps) == _tokens(jcomps)
        for r in reqs:
            solo = generate(tp, tcfg, np.asarray(r.prompt)[None],
                            max_new_tokens=6, max_len=16, use_kernels=uk,
                            device=CPU)
            assert _tokens(comps)[r.id] == solo[0, len(r.prompt):].tolist()


def test_engine_validation(model):
    """tests/test_serving_continuous.py:251, plus an exhausted pool and a
    ``mesh=`` that has no model axis."""
    _, tcfg, _, tp = model
    kw = dict(device=CPU, layout="paged")
    with pytest.raises(ValueError, match="multiple of"):
        ContinuousEngine(tp, tcfg, num_slots=2, max_len=20, page_size=8,
                         **kw)
    with pytest.raises(ValueError, match="cannot hold"):
        ContinuousEngine(tp, tcfg, num_slots=2, max_len=16, page_size=8,
                         total_pages=2, **kw)
    eng = ContinuousEngine(tp, tcfg, **ENGINE, **kw)
    long = np.zeros((14,), np.int32)
    with pytest.raises(ValueError, match="does not fit"):
        eng.run([Request(id=0, prompt=long, max_new_tokens=8)])
    with pytest.raises(ValueError, match="does not fit"):
        eng.run([Request(id=0, prompt=long[:4], max_new_tokens=0)])
    with pytest.raises(ValueError, match="must fit"):
        eng.submit(Request(id=0, prompt=long, max_new_tokens=8))
    # three pages: one full-length row; a second request must wait, and a
    # row that outgrows the pool mid-decode raises
    tight = ContinuousEngine(tp, tcfg, num_slots=2, max_len=16, page_size=8,
                             total_pages=3, use_kernels=False, **kw)
    two = [Request(id=i, prompt=np.arange(1, 9, dtype=np.int32),
                   max_new_tokens=8) for i in range(2)]
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        tight.run(two)
    with pytest.raises(ValueError, match="serving mesh needs"):
        ContinuousEngine(tp, tcfg, mesh=object(), **ENGINE, **kw)
    with pytest.raises(ValueError, match="generator"):
        ContinuousEngine(tp, tcfg, temperature=0.7, **ENGINE, **kw)


def test_engine_sampling_is_seeded(model):
    _, tcfg, _, tp = model
    reqs = _trace(tcfg, 4)

    def run(seed):
        return _tokens(ContinuousEngine(
            tp, tcfg, temperature=0.9, top_k=16, device=CPU,
            generator=torch.Generator().manual_seed(seed), **ENGINE)
            .run(reqs))

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert all(t < tcfg.vocab_size for toks in a.values() for t in toks)


def test_engine_observability_records_spans_and_slos(model):
    _, tcfg, _, tp = model
    obs = Observability()
    eng = ContinuousEngine(tp, tcfg, obs=obs, device=CPU, **ENGINE)
    eng.run(_trace(tcfg, 5))
    names = {e["name"] for e in obs.tracer.to_chrome()}
    assert {"serve.run", "serve.admit", "serve.decode_step"} <= names
    reg = obs.registry
    assert reg.get("serve/ttft_s").count == 5
    assert reg.get("serve/e2e_s").count == 5
    assert reg.get("serve/itl_s").count == 25       # 5 x (6 - 1) tokens
    assert reg.get("serve/completions").value == 5
    assert reg.get("serve/useful_tokens").value == 30
    assert reg.get("serve/page_pool_util").count == eng.steps
    assert "serve/ttft_s" in obs.summary()


def test_poisson_trace_equals_the_reference():
    jcfg, tcfg = _cfgs()
    kw = dict(rate=0.25, prompt_len_choices=(128, 256, 512),
              new_token_choices=(32, 64, 128), seed=0)
    got, want = poisson_trace(tcfg, 32, **kw), jpoisson_trace(jcfg, 32, **kw)
    assert len(got) == len(want) == 32
    for a, b in zip(got, want):
        assert (a.id, a.max_new_tokens, a.arrival) == \
            (b.id, b.max_new_tokens, b.arrival)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_run_static_trace_counts_the_same_useful_tokens(model):
    jcfg, tcfg, jp, tp = model
    kw = dict(rate=0.5, prompt_len_choices=(4, 7), new_token_choices=(2, 5),
              seed=1)
    got = run_static_trace(tp, tcfg, poisson_trace(tcfg, 5, **kw), batch=2,
                           max_len=16, use_kernels=False, device=CPU)
    want = jrun_static_trace(jp, jcfg, jpoisson_trace(jcfg, 5, **kw),
                             batch=2, max_len=16)
    assert got == want
    with pytest.raises(ValueError, match="max_len"):
        run_static_trace(tp, tcfg, poisson_trace(tcfg, 5, **kw), batch=2,
                         max_len=8, device=CPU)


# ---------------------------------------------------------------------------
# observability sinks
# ---------------------------------------------------------------------------


def _drive(obs):
    """One event sequence into either package's Observability."""
    r = np.random.RandomState(9)
    for v in np.concatenate([r.lognormal(-3, 1, 200), [0.0, -0.5, 2.0]]):
        obs.registry.observe("serve/itl_s", float(v))
    for _ in range(3):
        obs.registry.inc("serve/completions")
    obs.registry.set("serve/queue_depth", 4)
    obs.registry.observe("serve/ttft_s", 0.25)
    with obs.span("serve.run", requests=2):
        with obs.span("serve.admit", req=0):
            pass
        obs.tracer.instant("serve.mark", k=1)


def test_observability_equals_the_reference():
    """Registry records, histogram quantiles, the summary table and the
    trace's events (names, nesting, args; not wall-clock times) equal the
    reference's on one event sequence."""
    ours, theirs = Observability(), JObservability()
    _drive(ours)
    _drive(theirs)
    a, b = ours.registry, theirs.registry
    assert a.names() == b.names()
    strip = lambda recs: [{k: v for k, v in rec.items() if k != "ts"}  # noqa
                          for rec in recs]
    assert strip(a.to_records(ts=0.0)) == strip(b.to_records(ts=0.0))
    h, jh = a.get("serve/itl_s"), b.get("serve/itl_s")
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert ours.summary() == theirs.summary()
    keys = ("name", "ph", "args", "s")
    ev = [{k: e.get(k) for k in keys} for e in ours.tracer.to_chrome()]
    jev = [{k: e.get(k) for k in keys} for e in theirs.tracer.to_chrome()]
    assert ev == jev
    spans = {e["name"]: e for e in ours.tracer.to_chrome()}
    run, admit = spans["serve.run"], spans["serve.admit"]
    assert run["ts"] <= admit["ts"] and \
        admit["ts"] + admit["dur"] <= run["ts"] + run["dur"]
    with pytest.raises(TypeError):
        a.counter("serve/itl_s")


def test_observability_exports_and_the_disabled_path(tmp_path):
    obs = Observability(trace=False)
    _drive(obs)
    assert obs.tracer.to_chrome() == []
    assert obs.span("serve.x") is obs.span("serve.y")       # the singleton
    obs.write(trace_path=str(tmp_path / "t" / "trace.json"),
              metrics_path=str(tmp_path / "m" / "metrics.jsonl"))
    lines = (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len(obs.registry.names())
    obs.clear()
    assert obs.registry.names() == []
    annotated = Observability(annotate_device=True)
    with annotated.span("serve.decode_step"):
        pass
    assert annotated.tracer.to_chrome()[0]["name"] == "serve.decode_step"


# ---------------------------------------------------------------------------
# the token-at-a-time prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
def test_generate_without_fused_prefill(model, use_kernels):
    """``generate(fused_prefill=False)`` equals the fused path and the
    reference's; the fallback's last logits match the fused prefill's."""
    jcfg, tcfg, jp, tp = model
    prompts = np.random.RandomState(4).randint(0, tcfg.vocab_size, (2, 9))
    kw = dict(max_new_tokens=5, use_kernels=use_kernels)
    slow = generate(tp, tcfg, prompts, fused_prefill=False, device=CPU, **kw)
    fast = generate(tp, tcfg, prompts, device=CPU, **kw)
    ref = jgenerate(jp, jcfg, jnp.asarray(prompts, jnp.int32),
                    fused_prefill=False, **kw)
    assert torch.equal(slow, fast)
    np.testing.assert_array_equal(slow.numpy(), np.asarray(ref))
    layout = "head" if use_kernels else "seq"
    a, _ = prefill(tp, tcfg, torch.tensor(prompts),
                   TT.init_cache(tcfg, 2, 9, layout=layout, device=CPU),
                   use_kernels=use_kernels)
    b, _ = prefill_fused(tp, tcfg, torch.tensor(prompts),
                         TT.init_cache(tcfg, 2, 9, layout=layout, device=CPU),
                         use_kernels=use_kernels)
    _close(a, b, TOL, TOL)
    with pytest.raises(ValueError, match="fused prefill"):
        generate(tp, tcfg, prompts, fused_prefill=False, prompt_lens=(9, 4),
                 device=CPU, **kw)
