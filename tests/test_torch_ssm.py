"""The SSM slice held to the JAX package on the CPU: reduced falcon-mamba-7b
(d_model 256, d_inner 512, d_state 8, 2 layers, vocab 512) in f32, with the
reference's parameters carried across by ``convert.lm_to_torch`` (its
kernels: tests/test_torch_ssm_kernels.py).

The mixer (``ssm_forward`` with the kernels off and on, S a multiple of the
chunk or not, valid masking and the decode handoff; ``ssm_prefill`` and four
``ssm_decode`` steps) and the model (``prefill_forward``/``decode_step``
logits and caches) within 1e-4; greedy ``generate`` tokens equal to
``repro.serving.generate``; ragged rows equal to their unpadded runs;
``ContinuousEngine`` completions equal to the reference engine's and to
solo runs; ``lm_loss`` and its gradients (1e-5/1e-4), one train step and
``train_lm`` losses (1e-4). The port's plain path scans each chunk by
doubling where the reference uses ``lax.associative_scan``; its kernel path
runs the plain sequential scan on the CPU. ``F.softplus`` is the identity
above 20 where ``jax.nn.softplus`` is not; the difference there is below
2.1e-9.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.registry import get_config as jget_config
from repro.core import LargeBatchConfig as JLargeBatchConfig
from repro.core import Regime as JRegime
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro.serving import ContinuousEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import generate as jgenerate
from repro.train.trainer import make_lm_train_step as jmake_lm_train_step
from repro.train.trainer import train_lm as jtrain_lm
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.data import lm_sequences, token_lm
from repro_torch.kernels import mamba_scan as MS
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd
from repro_torch.serving import ContinuousEngine, Request, generate
from repro_torch.train import trainer as TR

TOL = 1e-4
CPU = "cpu"
ARCH = "falcon-mamba-7b"


def _cfgs():
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype="float32"),
            dataclasses.replace(get_config(ARCH).reduced(), dtype="float32"))


_REFERENCE = {}


def _reference(key, fn):
    """``fn()`` once per ``key``: a reference result the cases share (it
    does not depend on the port's ``use_kernels``)."""
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tree_close(got, want, tol=TOL):
    got_l = tree.leaves(convert.lm_to_numpy(got))
    want_l = jax.tree.leaves(jax.device_get(want))
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.shape == b.shape
        _close(a, b, tol)


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _ragged(P, lens, vocab, seed):
    full = _tokens((len(lens), P), vocab, seed)
    return np.where(np.arange(P)[None] >= P - np.array(lens)[:, None], full,
                    0).astype(np.int32)


def _mixer(model, layer=0):
    """Layer ``layer``'s mixer parameters in each package."""
    _, _, jp, tp = model
    jm = jax.tree.map(lambda a: a[layer], jp["stack"]["body"][0]["mixer"])
    return jm, tp["stack"]["body"][0][layer]["mixer"]


def _x(B, S, d, seed):
    return (0.5 * np.random.RandomState(seed).randn(B, S, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# parameter and cache trees
# ---------------------------------------------------------------------------


def test_params_and_caches_round_trip(model):
    """falcon's parameters (the f32 leaves A_log, D, dt_bias and the untied
    head included) and its SSM caches go across and back unchanged."""
    jcfg, tcfg, jp, tp = model
    layer = tp["stack"]["body"][0][0]
    assert set(layer) == {"norm1", "mixer"}
    assert {k: layer["mixer"][k].dtype for k in ("A_log", "D", "dt_bias")} \
        == dict.fromkeys(("A_log", "D", "dt_bias"), torch.float32)
    assert "head" in tp and tp["head"].shape == tp["embed"].shape
    for t_tree, j_tree in (
            (tp, jp),
            (convert.lm_to_torch(jax.device_get(
                JT.init_cache(jcfg, 3, 8)), tcfg, CPU),
             JT.init_cache(jcfg, 3, 8))):
        back = convert.lm_to_numpy(t_tree)
        ref = jax.device_get(j_tree)
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the port's own cache has the reference's leaves, shapes and dtypes
    mine = convert.lm_to_numpy(TT.init_cache(tcfg, 3, 8, device=CPU))
    ref = jax.device_get(JT.init_cache(jcfg, 3, 8))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape


def test_init_params_draws_every_leaf_of_the_reference(model):
    jcfg, tcfg, jp, _ = model
    mine = convert.lm_to_numpy(TT.init_params(0, tcfg, device=CPU))
    ref = jax.device_get(jp)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    body = mine["stack"]["body"][0]["mixer"]
    for name in ("A_log", "D", "dt_bias", "conv_b"):   # not random
        _close(body[name], ref["stack"]["body"][0]["mixer"][name], 1e-7)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S,chunk", [(32, 256), (40, 16), (300, 256)])
def test_ssm_forward_matches_reference(model, use_kernels, S, chunk):
    """One mixer over S steps in chunks (S = 40 and 300 are not multiples
    of the chunk: padded with identity steps) against the reference's plain
    path."""
    jcfg, tcfg, _, _ = model
    jm, tm = _mixer(model)
    x = _x(2, S, tcfg.d_model, S)
    want = _reference(("ssm_forward", S, chunk), lambda: jax.jit(
        lambda m, x_: JSSM.ssm_forward(m, jcfg, x_, chunk=chunk))(
            jm, jnp.asarray(x)))
    got = TSSM.ssm_forward(tm, tcfg, torch.tensor(x), chunk=chunk,
                           use_kernels=use_kernels)
    assert got.shape == (2, S, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_masked_state_handoff_matches_reference(model, use_kernels):
    """``valid`` masking and ``return_state``: the decode handoff (h, and the
    last d_conv - 1 masked inputs, zero-padded when S < d_conv - 1)."""
    jcfg, tcfg, _, _ = model
    jm, tm = _mixer(model, layer=1)
    for S, lens in ((12, (12, 5, 2)), (2, (2, 1, 2))):
        x = _x(3, S, tcfg.d_model, 7 + S)
        valid = np.arange(S)[None] >= S - np.array(lens)[:, None]
        jout, jst = JSSM.ssm_forward(jm, jcfg, jnp.asarray(x),
                                     valid=jnp.asarray(valid),
                                     return_state=True)
        out, st = TSSM.ssm_forward(tm, tcfg, torch.tensor(x),
                                   valid=torch.tensor(valid),
                                   use_kernels=use_kernels,
                                   return_state=True)
        assert st["conv"].shape == (3, tcfg.ssm.d_conv - 1,
                                    tcfg.ssm.d_inner(tcfg.d_model))
        _close(out[torch.tensor(valid)], np.asarray(jout)[valid])
        _close(st["h"], jst["h"])
        _close(st["conv"], jst["conv"])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_prefill_then_decode_matches_reference(model, use_kernels):
    """``ssm_prefill``'s states, then four ``ssm_decode`` steps: outputs and
    the carried h and conv state."""
    jcfg, tcfg, _, _ = model
    jm, tm = _mixer(model)
    x = _x(2, 10, tcfg.d_model, 1)
    jout, jc = JSSM.ssm_prefill(jm, jcfg, jnp.asarray(x))
    out, tc = TSSM.ssm_prefill(tm, tcfg, torch.tensor(x),
                               use_kernels=use_kernels)
    _close(out, jout)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    for i in range(4):
        xs = _x(2, 1, tcfg.d_model, 20 + i)
        jout, jc = JSSM.ssm_decode(jm, jcfg, jnp.asarray(xs), jc)
        out, tc = TSSM.ssm_decode(tm, tcfg, torch.tensor(xs), tc)
        _close(out, jout)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


def test_bf16_conv_state_is_rounded_through_bf16_and_kept_in_f32():
    """A bf16 model's prefill hands the conv state over rounded through
    bf16 and the cache keeps it in f32, as the reference's block does."""
    cfg = get_config(ARCH + "-reduced")
    assert cfg.dtype == "bfloat16"
    p = TT.init_params(0, cfg, device=CPU)
    toks = torch.tensor(_tokens((2, 9), cfg.vocab_size, 4))
    cache = TT.init_cache(cfg, 2, 12, device=CPU)
    TT.prefill_forward(p, cfg, toks, cache, use_kernels=False)
    conv = cache["body"][0][1]["ssm"]["conv"]
    assert conv.dtype == torch.float32
    assert torch.equal(conv, conv.bfloat16().float())
    # the second layer's last three inputs, recomputed
    x = torch.nn.functional.embedding(toks, p["embed"])
    h, _, _ = TB.block_apply(p["stack"]["body"][0][0], cfg,
                             cfg.body_pattern[0], x)
    hn = TL.rmsnorm_apply(p["stack"]["body"][0][1]["norm1"], h)
    xin, _ = TSSM._split_in(p["stack"]["body"][0][1]["mixer"], cfg, hn)
    assert torch.equal(conv, xin[:, -3:].float())
    assert cache["body"][0][1]["ssm"]["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the model: prefill, decode, generate, the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels,lens", [(False, None), (True, None),
                                              (False, (12, 5)),
                                              (True, (12, 5))])
def test_prefill_and_decode_match_reference(model, use_kernels, lens):
    """Fused prefill, then two decode steps: logits and every layer's SSM
    cache within 1e-4 (the reference's prefill with the Pallas kernel in
    interpret mode where the port takes its kernel path)."""
    jcfg, tcfg, jp, tp = model
    P, total = 12, 16
    toks = (_tokens((2, P), tcfg.vocab_size, 1) if lens is None
            else _ragged(P, lens, tcfg.vocab_size, 1))
    off = None if lens is None else (P - np.array(lens)).astype(np.int32)
    joff = None if off is None else jnp.asarray(off)
    toff = None if off is None else torch.tensor(off)
    jc = JT.init_cache(jcfg, 2, total, dtype=jnp.float32)
    tc = TT.init_cache(tcfg, 2, total, device=CPU)
    jl, jc = JT.prefill_forward(jp, jcfg, jnp.asarray(toks), jc,
                                use_kernels=use_kernels, offsets=joff)
    tl, tc = TT.prefill_forward(tp, tcfg, torch.tensor(toks), tc,
                                use_kernels=use_kernels, offsets=toff)
    _close(tl, jl)
    _tree_close(tc, jc)
    nxt = _tokens((2, 1), tcfg.vocab_size, 2)
    for pos in (P, P + 1):
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.int32(pos), use_kernels=use_kernels,
                                offsets=joff)
        tl, tc = TT.decode_step(tp, tcfg, torch.tensor(nxt), tc, pos,
                                use_kernels=use_kernels, offsets=toff)
        _close(tl, jl)
    _tree_close(tc, jc)


@pytest.mark.parametrize("use_kernels,ragged", [(False, False),
                                                (True, False),
                                                (False, True),
                                                (True, True)])
def test_generate_matches_reference(model, use_kernels, ragged):
    """Greedy tokens equal to ``repro.serving.generate`` (its plain path:
    the port's kernel path must give the same tokens)."""
    jcfg, tcfg, jp, tp = model
    if ragged:
        P, lens = 20, (4, 20, 13)
        prompts = _ragged(P, lens, tcfg.vocab_size, 3)
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=6,
                         prompt_lens=jnp.array(lens, jnp.int32))
        tout = generate(tp, tcfg, prompts, max_new_tokens=6,
                        prompt_lens=lens, use_kernels=use_kernels,
                        device=CPU)
    else:
        prompts = _tokens((3, 10), tcfg.vocab_size, 1)
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=12)
        tout = generate(tp, tcfg, prompts, max_new_tokens=12,
                        use_kernels=use_kernels, device=CPU)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ragged_matches_unpadded(model, use_kernels):
    """tests/test_serving.py's falcon-mamba case (P=20, lens (4, 20, 13)):
    each left-padded row continues exactly as it does alone unpadded (SSM
    rows see identity updates through the padding)."""
    _, tcfg, _, tp = model
    P, lens = 20, (4, 20, 13)
    padded = _ragged(P, lens, tcfg.vocab_size, 1)
    rag = generate(tp, tcfg, padded, max_new_tokens=6, prompt_lens=lens,
                   use_kernels=use_kernels, device=CPU)
    for b, L in enumerate(lens):
        solo = generate(tp, tcfg, padded[b:b + 1, P - L:], max_new_tokens=6,
                        use_kernels=use_kernels, device=CPU)
        np.testing.assert_array_equal(rag[b, P:].numpy(), solo[0, L:].numpy())


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


def _completions(comps):
    return {i: list(map(int, c.tokens)) for i, c in comps.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_continuous_engine_matches_reference_and_solo(model, use_kernels):
    """tests/test_serving_continuous.py's falcon-mamba case: 5 requests
    through 2 slots (slot reuse, mid-flight admission; the SSM state rows
    ride the admission scatter) equal the reference engine's completions
    and the port's own solo runs. The paged layout has no paged layer here:
    no block table is written and nothing is paged."""
    jcfg, tcfg, jp, tp = model
    kw = dict(num_slots=2, max_len=16, page_size=8)
    jcomps = JEngine(jp, jcfg, layout="paged", **kw).run(
        _trace(jcfg, 5, cls=JRequest))
    eng = ContinuousEngine(tp, tcfg, layout="paged", use_kernels=use_kernels,
                           device=CPU, **kw)
    comps = eng.run(_trace(tcfg, 5))
    assert sorted(comps) == list(range(5))
    assert _completions(comps) == _completions(jcomps)
    for r in _trace(tcfg, 5):
        solo = generate(tp, tcfg, np.asarray(r.prompt)[None],
                        max_new_tokens=6, max_len=16,
                        use_kernels=use_kernels, device=CPU)
        assert _completions(comps)[r.id] == solo[0, len(r.prompt):].tolist()
    assert set(eng.cache["body"][0][0]) == {"ssm"}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

B_, S_ = 2, 32


def _loss_and_grads(tp, tcfg, tokens, **kw):
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, metrics = TT.lm_loss(tree.unflatten(tp, leaves), tcfg,
                               {"tokens": torch.tensor(tokens)}, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, tree.unflatten(tp, list(grads))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_loss_and_grads_match_reference(model, use_kernels):
    """Loss 1e-5 and every gradient 1e-4 against jax.value_and_grad of the
    reference's loss (its plain path)."""
    jcfg, tcfg, jp, tp = model
    tokens = _tokens((B_, S_), tcfg.vocab_size, 1)
    (jloss, _), jgrads = _reference("lm_loss", lambda: jax.jit(
        jax.value_and_grad(lambda p: JT.lm_loss(
            p, jcfg, {"tokens": jnp.asarray(tokens)}), has_aux=True))(jp))
    MS.reset_launches()
    loss, _, grads = _loss_and_grads(tp, tcfg, tokens,
                                     use_kernels=use_kernels)
    assert MS.launches == {"mamba_chunk": 0, "mamba_chunk_backward": 0}
    _close(loss, jloss, 1e-5)
    _tree_close(grads, jgrads)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_train_step_matches_reference(model, use_kernels):
    """One momentum-SGD step from the same params and state (noise off):
    loss 1e-5, parameters and momentum 1e-4; the remat step equals the
    plain one."""
    jcfg, tcfg, jp, tp = model
    tokens = _tokens((B_, S_), tcfg.vocab_size, 3)
    jlb = JLargeBatchConfig(batch_size=B_, base_batch_size=B_, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=B_, base_batch_size=B_, grad_clip=1.0)
    jreg = JRegime(base_lr=0.01, total_steps=10, drop_every=10)
    reg = Regime(base_lr=0.01, total_steps=10, drop_every=10)
    jp2, jopt2, jm = _reference("train_step", lambda: jax.jit(
        jmake_lm_train_step(jcfg, jlb, jreg))(
            jp, jsgd.init(jp), {"tokens": jnp.asarray(tokens)}, jnp.int32(0),
            jax.random.PRNGKey(2)))
    outs = []
    for remat in (False, True):
        step = TR.make_lm_train_step(tcfg, lb, reg, use_kernels=use_kernels,
                                     remat=remat)
        outs.append(step(tp, sgd.init(tp), {"tokens": torch.tensor(tokens)},
                         0))
    (tp2, opt2, m), (rp2, _, rm) = outs
    _close(m["loss"], jm["loss"], 1e-5)
    _close(m["grad_norm"], jm["grad_norm"])
    _tree_close(tp2, jp2)
    _tree_close(opt2.momentum, jopt2.momentum)
    _close(rm["loss"], m["loss"].numpy(), 1e-6)
    for a, b in zip(tree.leaves(rp2), tree.leaves(tp2)):
        _close(a, b.numpy(), 1e-6)


def test_train_lm_losses_match_reference():
    """``train_lm`` over rows == batch_size from the reference's initial
    parameters: per-step losses within 1e-4, and falling."""
    jcfg, tcfg = _cfgs()
    stream = token_lm(0, vocab_size=tcfg.vocab_size, n_tokens=4 * 33)
    rows = lm_sequences(stream, 33)
    jlb = JLargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
    jreg = JRegime(base_lr=0.05, total_steps=4, drop_every=2)
    reg = Regime(base_lr=0.05, total_steps=4, drop_every=2)
    jout = jtrain_lm(jcfg, jlb, jreg, rows, seed=0, eval_every=1)
    init_key = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    tp = convert.lm_to_torch(jax.device_get(JT.init_params(init_key, jcfg)),
                             tcfg, CPU)
    for uk in (False, True):
        out = TR.train_lm(tcfg, lb, reg, rows, seed=0, eval_every=1,
                          params=tp, use_kernels=uk, device=CPU)
        assert out["steps"] == jout["steps"] == 4
        got = out["history"]["train_loss"]
        _close(np.asarray(got), np.asarray(jout["history"]["train_loss"]))
        assert got[-1] < got[0]
