"""The port's encoder-decoder and vision-LM families held to the JAX package
on the CPU, in f32: reduced seamless-m4t-large-v2 (a non-causal encoder
over stub frames, a cross block in every decoder layer) and reduced
llama-3.2-vision-11b (stub image embeddings, a cross block in every fifth
layer).

- LayerNorm (and its residual seam) and ``attention_full(segment_mask=)``
  against ``repro.models.layers``;
- ``encode`` and ``get_memory``; a cross block's output with no cache and
  its output and cache in prefill and decode, with and without
  ``use_kernels`` (the plain versions on the CPU); ``build_cross_cache``;
  ``forward`` logits; ``lm_loss`` and the gradients of every leaf, the
  encoder's included, with ``remat`` both ways (and a LayerNorm variant);
  greedy ``generate(memory=)`` tokens (ragged through the fused prefill,
  and token by token); one momentum-SGD train step.

Tolerances are the reference tests': loss 1e-5, grads and params 1e-4,
logits and caches 1e-4, tokens equal. Each cache path is held to the
reference's own path (cross K/V from the cache in prefill and decode,
projected from the memory with no cache). A reference result that cases
share (its plain path, which its kernel path equals in value; remat
changes no value) is computed once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.base import NormConfig as JNormConfig
from repro.configs.registry import get_config as jget_config
from repro.core import LargeBatchConfig as JLargeBatchConfig
from repro.core import Regime as JRegime
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro.serving import generate as jgenerate
from repro.train.trainer import make_lm_train_step as jmake_lm_train_step
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.configs.base import NormConfig
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd
from repro_torch.serving import generate
from repro_torch.train import trainer as TR

CPU = "cpu"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-11b")
LAYERNORM = "seamless-m4t-large-v2+layernorm"
T_TOKENS = 16            # training tokens; seamless's memory is T // 4


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _ragged(P, lens, vocab, seed):
    full = _tokens((len(lens), P), vocab, seed)
    return np.where(np.arange(P)[None] >= P - np.array(lens)[:, None], full,
                    0).astype(np.int32)


def _cfgs(arch):
    name, _, variant = arch.partition("+")
    j = dataclasses.replace(jget_config(name).reduced(), dtype="float32")
    t = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    if variant == "layernorm":
        j = dataclasses.replace(j, norm=JNormConfig(kind="layernorm"))
        t = dataclasses.replace(t, norm=NormConfig(kind="layernorm"))
    return j, t


_MODELS = {}
_REFERENCE = {}


def _reference(key, fn):
    """``fn()`` once per ``key``: a reference result the cases share."""
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if tcfg.norm.kind == "layernorm":
            # random scales and biases, so every LayerNorm leaf is seen
            jp = jax.tree_util.tree_map_with_path(
                lambda path, a: a + 0.1 * jax.random.normal(
                    jax.random.PRNGKey(len(str(path))), a.shape)
                if str(path[-1]) in ("['scale']", "['bias']") else a, jp)
        tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def _batch(tcfg, B, T, seed):
    """Tokens and the family's memory input, as ``repro.launch.train``'s
    ``extra_inputs`` shapes them (0.1 * normal)."""
    out = {"tokens": _tokens((B, T), tcfg.vocab_size, seed)}
    if tcfg.encoder is not None:
        out["frames"] = _x((B, max(1, T // tcfg.encoder.frame_ratio),
                            tcfg.encoder.d_model), seed + 1, 0.1)
    if tcfg.vision is not None:
        out["image_embeds"] = _x((B, tcfg.vision.n_image_tokens,
                                  tcfg.d_model), seed + 1, 0.1)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.tensor(v).long() if k == "tokens" else torch.tensor(v)
             for k, v in out.items()})


def _memory(arch, B, seed, use_kernels=False):
    """The family's memory in both packages, from one input."""
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(tcfg, B, T_TOKENS, seed)
    jm = JT.get_memory(jp, jcfg, jb)
    with torch.no_grad():
        tm = TT.get_memory(tp, tcfg, tb, use_kernels=use_kernels)
    return jm, tm


def _tree_close(got, want, tol):
    got_l = tree.leaves(convert.lm_to_numpy(got))
    want_l = jax.tree.leaves(jax.device_get(want))
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        _close(a, b, tol)


# ---------------------------------------------------------------------------
# layers: LayerNorm, segment masks
# ---------------------------------------------------------------------------


def test_layernorm_matches_reference():
    """``layernorm_apply`` and the LayerNorm branches of ``norm_apply`` and
    ``norm_residual_apply`` (two-pass with kernels on too) at 1e-5, in f32
    and bf16 inputs."""
    jcfg, tcfg = _cfgs(LAYERNORM)
    d = tcfg.d_model
    p = {"scale": _x((d,), 1), "bias": _x((d,), 2)}
    tparams = {k: torch.tensor(v) for k, v in p.items()}
    assert TL.norm_init(tcfg, d, CPU).keys() == {"scale", "bias"}
    for dt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                         (jnp.bfloat16, torch.bfloat16, 1e-2)):
        x, r = _x((3, 7, d), 3, 4.0), _x((3, 7, d), 4)
        jx, jr = jnp.asarray(x, dt), jnp.asarray(r, dt)
        tx, tr = torch.tensor(x).to(tdt), torch.tensor(r).to(tdt)
        want = JL.norm_apply(jcfg, p, jx)
        _close(TL.layernorm_apply(tparams, tx, tcfg.norm.eps), want, tol)
        wh, ws = JL.norm_residual_apply(jcfg, p, jx, jr, use_kernels=True)
        for uk in (False, True):
            got = TL.norm_apply(tcfg, tparams, tx, use_kernels=uk)
            assert got.dtype == tdt
            _close(got, want, tol)
            h, s = TL.norm_residual_apply(tcfg, tparams, tx, tr,
                                          use_kernels=uk)
            _close(h, wh, tol)
            _close(s, ws, tol)


SEGMENT_CASES = [(True, None, "2d"), (False, None, "2d"), (True, 4, "3d"),
                 (False, None, "3d")]


@pytest.mark.parametrize("causal,window,kind", SEGMENT_CASES)
def test_segment_mask_matches_reference(causal, window, kind):
    """``attention_full(segment_mask=)`` (a (T, T) or per-row (B, T, T)
    mask of two segments) against the reference; with kernels on, a
    masked call takes the plain path (the reference's condition)."""
    jcfg, tcfg, jp, tp = _model("llama-3.2-vision-11b")
    jblk = jax.tree.map(lambda a: a[0], jp["stack"]["body"][1])["mixer"]
    tblk = tp["stack"]["body"][1][0]["mixer"]
    B, T = 2, 20
    x = _x((B, T, tcfg.d_model), 5)
    pos = np.broadcast_to(np.arange(T), (B, T))
    seg = np.arange(T) >= np.array([[7], [12]])           # (B, T)
    m = seg[:, :, None] == seg[:, None, :]                # (B, T, T)
    if kind == "2d":
        m = m[0]
    want = JL.attention_full(jblk, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             window=window, causal=causal,
                             segment_mask=jnp.asarray(m))
    for uk in (False, True):
        got = TL.attention_full(tblk, tcfg, torch.tensor(x),
                                torch.tensor(pos), window=window,
                                causal=causal,
                                segment_mask=torch.tensor(m),
                                use_kernels=uk)
        _close(got, want, LOGIT_TOL)


# ---------------------------------------------------------------------------
# the memory and the cross block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + (LAYERNORM,))
def test_encode_and_get_memory_match_reference(arch):
    """seamless: the encoder's output over the frames (and ``encode``
    alone, kernels on: the non-causal attention is plain either way);
    llama-vision: the image embeddings as given."""
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(tcfg, 2, T_TOKENS, 7)
    jm = JT.get_memory(jp, jcfg, jb)
    for uk in (False, True):
        tm = TT.get_memory(tp, tcfg, tb, use_kernels=uk)
        assert tm.shape == (2, TT.memory_len(tcfg, T_TOKENS), tcfg.d_model)
        assert TT.memory_len(tcfg, T_TOKENS) == JT.memory_len(jcfg, T_TOKENS)
        _close(tm, jm, LOGIT_TOL)
    if tcfg.encoder is not None:
        ecfg = TT.encoder_config(tcfg)
        assert not ecfg.causal and ecfg.n_layers == tcfg.encoder.n_layers
        assert dataclasses.asdict(ecfg) == dataclasses.asdict(
            JT.encoder_config(jcfg))
        _close(TT.encode(tp, tcfg, tb["frames"], use_kernels=True),
               JT.encode(jp, jcfg, jb["frames"]), LOGIT_TOL)
    else:
        assert tm is tb["image_embeds"]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_block_matches_reference(arch, use_kernels):
    """A cross block (its own norm_x and residual add before the mixer)
    with no cache: the output and the gradients of every leaf of
    sum(out * w) and of the memory; then against a cache whose cross K/V
    were projected once: the prefill's output and cache (the cross K/V
    passed on unchanged), and one decode step's."""
    jcfg, tcfg, jp, tp = _model(arch)
    slot = next(j for j, s in enumerate(tcfg.body_pattern) if s.cross_attn)
    spec = tcfg.body_pattern[slot]
    jblk = jax.tree.map(lambda a: a[0], jp["stack"]["body"][slot])
    tblk = tp["stack"]["body"][slot][0]
    assert {"norm_x", "cross", "norm1", "mixer"} <= set(tblk)
    B, T = 2, 12
    x, w = _x((B, T, tcfg.d_model), 8), _x((B, T, tcfg.d_model), 9)
    pos = np.broadcast_to(np.arange(T), (B, T))
    jm, _ = _memory(arch, B, 10)
    mem = np.asarray(jm)

    def jloss(p, m):
        y, _, _ = JB.block_apply(p, jcfg, jcfg.body_pattern[slot],
                                 jnp.asarray(x), positions=jnp.asarray(pos),
                                 memory=m)
        return jnp.sum(y * w), y

    (_, jy), (jg, jgm) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(jblk, jm)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tblk)]
    tmem = torch.tensor(mem, requires_grad=True)
    y, cache, _ = TB.block_apply(tree.unflatten(tblk, leaves), tcfg, spec,
                                 torch.tensor(x), positions=torch.tensor(pos),
                                 memory=tmem, use_kernels=use_kernels)
    assert cache is None
    grads = torch.autograd.grad((y * torch.tensor(w)).sum(),
                                leaves + [tmem])
    _close(y, jy, LOGIT_TOL)
    for g, want in zip(grads, jax.tree.leaves(jg) + [jgm]):
        _close(g, want, GRAD_TOL)

    # prefill and one decode step against a cache
    S = mem.shape[1]
    jc = JB.block_cache(jcfg, jcfg.body_pattern[slot], B, T + 1, S,
                        dtype=jnp.float32)
    jk, jv = JL.cross_kv(jblk["cross"], jcfg, jm)
    jc = dict(jc, cross_k=jk, cross_v=jv)
    layout = "head" if use_kernels else "seq"
    tc = TB.block_cache(tcfg, spec, B, T + 1, torch.float32, layout,
                        device=CPU, memory_len=S)
    assert tc["cross_k"].shape == (B, S, tcfg.n_kv_heads, tcfg.head_dim)
    k, v = TL.cross_kv(tblk["cross"], tcfg, torch.tensor(mem))
    tc["cross_k"].copy_(k)
    tc["cross_v"].copy_(v)
    jy, jc, _ = JB.block_apply(jblk, jcfg, jcfg.body_pattern[slot],
                               jnp.asarray(x), positions=jnp.asarray(pos),
                               cache=jc)
    with torch.no_grad():
        y, tc, _ = TB.block_apply(tblk, tcfg, spec, torch.tensor(x),
                                  positions=torch.tensor(pos), cache=tc,
                                  use_kernels=use_kernels)
    _close(y, jy, LOGIT_TOL)
    for name in ("cross_k", "cross_v"):
        _close(tc[name], jc[name], LOGIT_TOL)
    kname = "kh" if use_kernels else "k"
    got_k = tc["attn"][kname]
    got_k = got_k.transpose(1, 2) if use_kernels else got_k
    _close(got_k[:, :T], jc["attn"]["k"][:, :T], LOGIT_TOL)
    xd = _x((B, 1, tcfg.d_model), 11)
    jy, jc, _ = JB.block_apply(jblk, jcfg, jcfg.body_pattern[slot],
                               jnp.asarray(xd), cache=jc, pos=jnp.int32(T),
                               decode=True)
    with torch.no_grad():
        y, tc, _ = TB.block_apply(tblk, tcfg, spec, torch.tensor(xd),
                                  cache=tc, pos=T, decode=True,
                                  use_kernels=use_kernels)
    _close(y, jy, LOGIT_TOL)
    _close(tc["cross_v"], jc["cross_v"], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cross_cache_matches_reference(arch):
    """Every cross block's projected K/V, in the cache's dtype (f32 and
    bf16 caches), and zeros past them in a non-cross block."""
    jcfg, tcfg, jp, tp = _model(arch)
    jm, tm = _memory(arch, 3, 12)
    S = tm.shape[1]
    assert TT.memory_len(tcfg, T_TOKENS) == S
    for jdt, tdt, tol in ((jnp.float32, torch.float32, LOGIT_TOL),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        jc = JT.build_cross_cache(jp, jcfg, jm, JT.init_cache(
            jcfg, 3, 8, memory_len=S, dtype=jdt))
        tc = TT.init_cache(tcfg, 3, 8, memory_len=S, dtype=tdt, device=CPU)
        assert TT.build_cross_cache(tp, tcfg, tm, tc) is tc
        for j, spec in enumerate(tcfg.body_pattern):
            for i in range(tcfg.body_repeats):
                c = tc["body"][j][i]
                if not spec.cross_attn:
                    assert "cross_k" not in c
                    continue
                for name in ("cross_k", "cross_v"):
                    assert c[name].dtype == tdt
                    _close(c[name], jc["body"][j][name][i], tol)


# ---------------------------------------------------------------------------
# the model: logits, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(tcfg, 2, T_TOKENS, 13)
    jm = JT.get_memory(jp, jcfg, jb)
    jl, _ = JT.forward(jp, jcfg, jb["tokens"], memory=jm)
    with torch.no_grad():
        tm = TT.get_memory(tp, tcfg, tb)
        tl, aux = TT.forward(tp, tcfg, tb["tokens"], memory=tm)
    assert tl.shape == (2, T_TOKENS, tcfg.padded_vocab)
    _close(tl, jl, LOGIT_TOL)
    assert float(aux["moe_aux"]) == 0.0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS + (LAYERNORM,))
def test_lm_loss_and_grads_match_reference(arch, remat):
    """The loss and the gradients of every leaf, the encoder's and the
    cross blocks' included (the memory is an input of each rematerialized
    block, so its gradient reaches the encoder)."""
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(tcfg, 2, T_TOKENS, 14)
    (jloss, jm), jgrads = _reference(("lm_loss", arch), lambda: (
        jax.value_and_grad(lambda p: JT.lm_loss(p, jcfg, jb),
                           has_aux=True)(jp)))
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, m = TT.lm_loss(tree.unflatten(tp, leaves), tcfg, tb, remat=remat)
    grads = tree.unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    _close(loss, jloss, LOSS_TOL)
    _close(m["ce"], jm["ce"], LOSS_TOL)
    _tree_close(grads, jgrads, GRAD_TOL)
    cross = [g for s, g in TB.each_layer(grads["stack"], tcfg)
             if s.cross_attn]
    assert cross and all(float(g["cross"]["wk"].abs().max()) > 0
                         for g in cross)
    if tcfg.encoder is not None:
        assert float(max(t.abs().max() for t in
                         tree.leaves(grads["encoder"]))) > 0


# ---------------------------------------------------------------------------
# serving and training
# ---------------------------------------------------------------------------


GEN_CASES = [(False, True), (True, True), (False, False), (True, False)]


@pytest.mark.parametrize("use_kernels,fused", GEN_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, use_kernels, fused):
    """Greedy ``generate(memory=)`` tokens equal to
    ``repro.serving.generate``: ragged left-padded prompts through the
    fused prefill, and token by token (no ragged prompts there)."""
    jcfg, tcfg, jp, tp = _model(arch)
    jm, tm = _memory(arch, 3, 15)
    if fused:
        P, lens = 14, (4, 14, 9)
        prompts = _ragged(P, lens, tcfg.vocab_size, 3)
        kw = dict(prompt_lens=lens)
        jkw = dict(prompt_lens=jnp.array(lens, jnp.int32))
    else:
        prompts = _tokens((3, 10), tcfg.vocab_size, 4)
        kw = dict(fused_prefill=False)
        jkw = dict(fused_prefill=False)
    jout = _reference(("generate", arch, fused), lambda: np.asarray(
        jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=8,
                  memory=jm, **jkw)))
    tout = generate(tp, tcfg, prompts, max_new_tokens=8, memory=tm,
                    use_kernels=use_kernels, device=CPU, **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One momentum-SGD step (noise off) on a batch carrying the memory's
    input: loss 1e-5, parameters (encoder included) 1e-4."""
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(tcfg, 2, T_TOKENS, 16)
    jlb = JLargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    jstep = jax.jit(jmake_lm_train_step(jcfg, jlb, JRegime(
        base_lr=0.1, total_steps=10, drop_every=10)))
    step = TR.make_lm_train_step(tcfg, lb, Regime(base_lr=0.1,
                                                  total_steps=10,
                                                  drop_every=10))
    jp2, _, jm = jstep(jp, jsgd.init(jp), jb, jnp.int32(0),
                       jax.random.PRNGKey(2))
    tp2, _, m = step(tp, sgd.init(tp), tb, 0)
    for name in ("loss", "ce"):
        _close(m[name], jm[name], LOSS_TOL)
    _tree_close(tp2, jp2, GRAD_TOL)
