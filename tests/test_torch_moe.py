"""The port's Mixture-of-Experts held to the JAX package on the CPU, in f32.

- ``_route`` (top-k indices, renormalised weights, the Switch and z
  losses), the capacity slots and ``keep`` (dropless and at a capacity
  where assignments drop), ``moe_apply`` over a sequence and in decode
  (S == 1: the batch folds into one sequence), the dispatch buffer and the
  shared expert, against ``repro.models.moe`` at 2e-4 (tests/test_moe.py's
  bound);
- a block, the stack and ``lm_loss`` with the gradients of every leaf,
  router included, with and without remat (loss 1e-5, grads 1e-4);
- prefill and decode logits (1e-4) with the routing compared first, layer
  by layer, and greedy ``generate`` tokens, for reduced qwen2-moe-a2.7b
  and kimi-k2-1t-a32b (a dense head layer and an MoE body); one train step;
  ``ContinuousEngine`` completions against the reference engine's.

Routing is discontinuous: a last-bit difference in a router logit can flip
a top-k choice or a capacity slot. Routing is therefore compared before any
value: ``topi`` equal, and then ``slot``, ``keep`` and the capacity equal on
every sequence routed alike. A token routed differently fails unless two of
its k + 1 largest probabilities lie within NEAR_TIE of each other (a
near-tie that no two implementations decide alike); such tokens are
counted and printed. The reference's routing is read while it runs
eagerly (``jax.disable_jit``): its expert-parallel entry point is made to
take the call, records the slots its routing computed, and hands back the
reference's own single-device output.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.registry import get_config as jget_config
from repro.core import LargeBatchConfig as JLargeBatchConfig
from repro.core import Regime as JRegime
from repro.core import expert_parallel as JEP
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro.serving import ContinuousEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import generate as jgenerate
from repro.train.trainer import make_lm_train_step as jmake_lm_train_step
from repro_torch import convert, tree
from repro_torch.configs import LayerSpec, ModelConfig, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.core import expert_parallel as EP
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TT
from repro_torch.optim import sgd
from repro_torch.serving import ContinuousEngine, Request, generate
from repro_torch.train import trainer as TR

CPU = "cpu"
TOL = 2e-4            # tests/test_moe.py
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
NEAR_TIE = 1e-6
ARCHS = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol):
    """Within ``tol`` of want's largest entry, as PERF.md holds sums taken
    in another order: the reference's expert init (1/sqrt(E), not
    1/sqrt(d)) makes an MoE block's activations O(100)-O(1000), where f32
    carries ~1e-4 absolute."""
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err:.3e} > {tol} x {scale:.3e}"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# recording the routing of both packages
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _port_routing(log):
    """Record every port MoE layer's routing input, topi, slot, keep, C."""
    real_route, real_slots = MOE._route, MOE._slots

    def route(router_w, x, m, losses=True):
        out = real_route(router_w, x, m, losses)
        log.append({"x": _np(x.float()), "router": _np(router_w.float()),
                    "topi": _np(out[0])})
        return out

    def slots(topi, C):
        slot, keep = real_slots(topi, C)
        log[-1].update(slot=_np(slot), keep=_np(keep), C=C)
        return slot, keep

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MOE, "_route", route)
        mp.setattr(MOE, "_slots", slots)
        yield log


@contextlib.contextmanager
def _reference_routing(log):
    """Record every reference MoE layer's topi, slot, keep and C as it runs
    eagerly. ``ep_applicable`` sends the call to ``ep_dispatch_combine``,
    which records the routing and returns the reference's own fallback
    output (``moe_apply`` again, without the shared expert, which the
    outer call adds)."""
    real_route, real_moe = JMOE._route, JMOE.moe_apply
    inner = [False]

    def route(router_w, x, m, dp_axes=()):
        out = real_route(router_w, x, m, dp_axes)
        if not inner[0]:
            log.append({"topi": np.asarray(out[0])})
        return out

    def dispatch(params, m, x, topi, topw, slot, keep, C, mesh,
                 batch_axis=0):
        log[-1].update(slot=np.asarray(slot), keep=np.asarray(keep), C=C)
        routed = types.SimpleNamespace(
            moe=dataclasses.replace(m, n_shared_experts=0))
        inner[0] = True
        try:
            return real_moe(params, routed, x)[0]
        finally:
            inner[0] = False

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JMOE, "_route", route)
        mp.setattr(JEP, "ep_applicable", lambda *a: not inner[0])
        mp.setattr(JEP, "ep_dispatch_combine", dispatch)
        yield log


def _near_ties(x, router, k):
    """(..., ) True where two of a token's k + 1 largest router
    probabilities (f64, from the port's routing input) are within
    NEAR_TIE."""
    logits = x.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[..., :k + 1]
    return (-np.diff(top, axis=-1) < NEAR_TIE).any(-1)


def _check_routing(tlog, jlog, label):
    """Layer by layer: topi equal (near-ties counted), then slot, keep and
    C equal on every sequence routed alike. Returns the near-tie count."""
    assert len(tlog) == len(jlog) > 0, (len(tlog), len(jlog))
    flips = 0
    for i, (t, j) in enumerate(zip(tlog, jlog)):
        assert t["C"] == j["C"], (label, i, t["C"], j["C"])
        diff = (t["topi"] != j["topi"]).any(-1)
        if diff.any():
            tie = _near_ties(t["x"], t["router"], t["topi"].shape[-1])
            bad = diff & ~tie
            assert not bad.any(), (
                f"{label} layer {i}: {int(bad.sum())} tokens routed "
                f"differently with no near-tie")
            flips += int(diff.sum())
        alike = ~diff.any(-1)                  # sequences routed alike
        np.testing.assert_array_equal(t["slot"][alike], j["slot"][alike])
        np.testing.assert_array_equal(t["keep"][alike], j["keep"][alike])
    if flips:
        print(f"{label}: {flips} near-tie tokens routed differently")
    return flips


# ---------------------------------------------------------------------------
# the layer: routing, slots, moe_apply
# ---------------------------------------------------------------------------


def _mk_cfgs(E=4, k=2, cf=1.25, shared=0):
    """tests/test_moe.py's small config, in both packages."""
    kw = dict(name="t", family="moe", d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab_size=64, body_repeats=1, dtype="float32")
    mkw = dict(n_experts=E, top_k=k, d_expert=16, capacity_factor=cf,
               n_shared_experts=shared, d_shared=16 if shared else 0)
    j = JModelConfig(body_pattern=(JLayerSpec(mixer="attn", ff="moe"),),
                     moe=JMoEConfig(**mkw), **kw)
    t = ModelConfig(body_pattern=(LayerSpec(mixer="attn", ff="moe"),),
                    moe=MoEConfig(**mkw), **kw)
    return j, t


def _layer(seed, **kw):
    jcfg, tcfg = _mk_cfgs(**kw)
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 3), (4, 4)])
def test_route_matches_reference(E, k):
    jcfg, tcfg, jp, tp = _layer(0, E=E, k=k)
    x = _x((2, 24, 32), 1)
    jtopi, jtopw, jaux = JMOE._route(jp["router"], jnp.asarray(x), jcfg.moe)
    topi, topw, aux = MOE._route(tp["router"], torch.tensor(x), tcfg.moe)
    assert topi.shape == (2, 24, k) and topi.dtype == torch.int64
    diff = (_np(topi) != np.asarray(jtopi)).any(-1)
    assert not (diff & ~_near_ties(x, _np(tp["router"]), k)).any()
    _close(topw, jtopw, TOL)
    np.testing.assert_allclose(_np(topw.sum(-1)), 1.0, rtol=1e-5)
    for name in ("moe_aux", "moe_z"):
        _close(aux[name], jaux[name], TOL)
    assert float(aux["moe_aux"]) >= 0.99     # E sum f P >= 1 (Cauchy-Schwarz)


SLOT_CASES = [(4, 1, 100.0), (4, 2, 100.0), (4, 1, 0.3), (8, 3, 0.5),
              (4, 2, 1.25)]


@pytest.mark.parametrize("E,k,cf", SLOT_CASES)
def test_slots_and_keep_match_reference(E, k, cf):
    """Dropless (cf 100) and with drops: the port's slots from the
    reference's own topi equal the reference's slots and keep."""
    jcfg, tcfg, jp, tp = _layer(1, E=E, k=k, cf=cf)
    x = _x((3, 32, 32), 2)
    jlog = []
    with _reference_routing(jlog):
        JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    rec, = jlog
    C = tcfg.moe.tokens_capacity(32)
    assert rec["C"] == C
    slot, keep = MOE._slots(torch.tensor(rec["topi"]).long(), C)
    np.testing.assert_array_equal(_np(slot), rec["slot"])
    np.testing.assert_array_equal(_np(keep), rec["keep"])
    if cf >= 100.0:
        assert keep.all()
    elif cf < 1.0:
        assert not keep.all() and keep.any()
    # every kept (b, e, slot) is unique: the scatter writes each row once
    topi = torch.tensor(rec["topi"]).long()
    rows = EP.dispatch_rows(topi, slot, C)[keep]
    assert rows.unique().numel() == rows.numel()
    assert int((slot < C).sum()) == int(keep.sum())


MOE_CASES = [
    # (E, k, cf, shared, B, S)
    (4, 2, 1.25, 0, 2, 24),
    (4, 2, 100.0, 1, 2, 24),
    (4, 1, 0.3, 1, 1, 32),
    (8, 3, 1.25, 1, 5, 1),        # decode: capacity pools over the batch
    (4, 2, 0.5, 0, 6, 1),
]


@pytest.mark.parametrize("E,k,cf,shared,B,S", MOE_CASES)
def test_moe_apply_matches_reference(E, k, cf, shared, B, S):
    """The output, the aux losses, the dispatch buffer (the reference's
    (B, E, C, d) against the port's expert-major rows) and the routing."""
    jcfg, tcfg, jp, tp = _layer(2, E=E, k=k, cf=cf, shared=shared)
    x = _x((B, S, 32), 3)
    bufs = {}
    real_ff, real_eff = JMOE._expert_ff, EP.expert_ff

    def jff(p, m, buf):
        bufs["ref"] = np.asarray(buf)
        return real_ff(p, m, buf)

    def tff(buf, *w):
        bufs["port"] = _np(buf)
        return real_eff(buf, *w)

    jlog, tlog = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMOE, "_expert_ff", jff)
        mp.setattr(EP, "expert_ff", tff)
        with jax.disable_jit():
            jy, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
        with _reference_routing(jlog):
            JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
        with _port_routing(tlog):
            y, aux = MOE.moe_apply(tp, tcfg, torch.tensor(x))
    assert _check_routing(tlog, jlog, "moe_apply") == 0
    Bf, Sf = (1, B) if S == 1 else (B, S)
    C = tcfg.moe.tokens_capacity(Sf)
    assert tlog[0]["C"] == C and tlog[0]["topi"].shape == (Bf, Sf, k)
    want = bufs["ref"]                                 # (Bf, E, C, d)
    got = bufs["port"].reshape(E, Bf, C, 32).transpose(1, 0, 2, 3)
    _close(got, want, TOL)
    assert y.shape == (B, S, 32)
    _close(y, jy, TOL)
    for name in ("moe_aux", "moe_z"):
        _close(aux[name], jaux[name], TOL)


def test_losses_off_gives_the_same_output_and_zero_losses():
    """Prefill and decode skip the router losses (their callers drop
    them): the output is bit-equal, and no loss is computed."""
    _, tcfg, _, tp = _layer(3, E=8, k=3, cf=0.5, shared=1)
    x = torch.tensor(_x((2, 16, 32), 9))
    y, aux = MOE.moe_apply(tp, tcfg, x)
    y0, aux0 = MOE.moe_apply(tp, tcfg, x, losses=False)
    assert torch.equal(y, y0)
    assert float(aux["moe_aux"]) > 0.99
    assert aux0 == {}


def test_dropless_equals_the_dense_per_token_sum():
    """tests/test_moe.py: with a huge capacity the output is each token's
    weighted sum of its top-k expert MLPs."""
    _, tcfg, _, tp = _layer(0, E=4, k=2, cf=100.0)
    x = torch.tensor(_x((1, 8, 32), 4))
    y, _ = MOE.moe_apply(tp, tcfg, x)
    topi, topw, _ = MOE._route(tp["router"], x, tcfg.moe)
    want = torch.zeros_like(x)
    for t in range(8):
        for j in range(2):
            e = int(topi[0, t, j])
            g = torch.nn.functional.silu(x[0, t] @ tp["w_gate"][e])
            u = x[0, t] @ tp["w_up"][e]
            want[0, t] += topw[0, t, j] * ((g * u) @ tp["w_down"][e])
    _close(y, want, TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_shared_expert_always_on(use_kernels):
    """tests/test_moe.py: with ~everything routed dropped, the output is the
    shared expert's for the dropped tokens; the port equals the reference
    (the fused SwiGLU's plain version on the CPU with kernels on)."""
    jcfg, tcfg, jp, tp = _layer(0, E=4, k=1, cf=0.01, shared=1)
    x = _x((1, 16, 32), 5)
    y, _ = MOE.moe_apply(tp, tcfg, torch.tensor(x), use_kernels=use_kernels)
    jy, _ = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    _close(y, jy, TOL)
    shared = TL.mlp_apply(tp["shared"], torch.tensor(x))
    _close(shared, JL.mlp_apply(jp["shared"], jnp.asarray(x)), TOL)
    assert float((y - shared).abs().amax(-1).min()) < 1e-5


def test_params_shapes_and_dtypes():
    cfg = get_config("qwen2-moe-a2.7b-reduced")
    p = TB.block_init(torch.Generator().manual_seed(0), cfg,
                      cfg.body_pattern[0], torch.bfloat16)
    m = cfg.moe
    ff = p["ff"]
    assert ff["router"].shape == (cfg.d_model, m.n_experts)
    assert ff["router"].dtype == torch.float32
    assert ff["w_gate"].shape == (m.n_experts, cfg.d_model, m.d_expert)
    assert ff["w_down"].shape == (m.n_experts, m.d_expert, cfg.d_model)
    assert ff["w_up"].dtype == torch.bfloat16
    assert ff["shared"]["w_gate"].shape == (cfg.d_model, m.d_shared)
    assert p["norm2"]["scale"].dtype == torch.float32
    full = get_config("qwen2-moe-a2.7b")
    assert full.moe.tokens_capacity(512) == 42
    assert full.moe.tokens_capacity(8) == 4


# ---------------------------------------------------------------------------
# the models: reduced qwen2-moe-a2.7b and kimi-k2-1t-a32b
# ---------------------------------------------------------------------------


def _cfgs(arch, **overrides):
    j = dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                            **overrides)
    t = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                            **overrides)
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
        tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _ragged(P, lens, vocab, seed):
    full = _tokens((len(lens), P), vocab, seed)
    return np.where(np.arange(P)[None] >= P - np.array(lens)[:, None], full,
                    0).astype(np.int32)


def _tree_close(got, want, tol, close=_close):
    got_l = tree.leaves(convert.lm_to_numpy(got))
    want_l = jax.tree.leaves(jax.device_get(want))
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        close(a, b, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for name in (arch, arch + "-reduced"):
        j, t = jget_config(name), get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_reference(arch, use_kernels):
    """One MoE body block: output, aux and the gradients of every leaf
    (router included) of sum(out * w) + aux + z."""
    jcfg, tcfg, jp, tp = _model(arch)
    spec = tcfg.body_pattern[0]
    assert spec.ff == "moe"
    jblock = jax.tree.map(lambda a: a[0], jp["stack"]["body"][0])
    tblock = tp["stack"]["body"][0][0]
    x = _x((2, 16, tcfg.d_model), 6)
    w = _x((2, 16, tcfg.d_model), 7)
    pos = np.broadcast_to(np.arange(16), (2, 16))

    def jloss(p):
        y, _, a = JB.block_apply(p, jcfg, jcfg.body_pattern[0],
                                 jnp.asarray(x), positions=jnp.asarray(pos))
        return jnp.sum(y * w) + a["moe_aux"] + a["moe_z"], (y, a)

    # the reference does not depend on use_kernels: once per arch
    (jl, (jy, ja)), jg = _reference(("block", arch), lambda: jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jblock))
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tblock)]
    p = tree.unflatten(tblock, leaves)
    y, cache, a = TB.block_apply(p, tcfg, spec, torch.tensor(x),
                                 positions=torch.tensor(pos),
                                 use_kernels=use_kernels)
    assert cache is None
    loss = (y * torch.tensor(w)).sum() + a["moe_aux"] + a["moe_z"]
    grads = torch.autograd.grad(loss, leaves)
    _close_scaled(y, jy, TOL)
    for name in ("moe_aux", "moe_z"):
        _close(a[name], ja[name], TOL)
    _close_scaled(loss, jl, TOL)
    for g, jg_ in zip(grads, jax.tree.leaves(jg)):
        _close_scaled(g, jg_, GRAD_TOL)
    assert float(grads[tree.leaves(tblock).index(tblock["ff"]["router"])]
                 .abs().max()) > 0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_stack_output_and_aux_match_reference(arch, remat):
    """The stack's output and its aux losses, summed over the layers."""
    jcfg, tcfg, jp, tp = _model(arch)
    x = _x((2, 16, tcfg.d_model), 8)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    jy, _, ja = jax.jit(lambda p, x_, pos_: JB.stack_apply(
        p, jcfg, x_, positions=pos_, remat=remat))(
            jp["stack"], jnp.asarray(x), jnp.asarray(pos))
    y, cache, a = TB.stack_apply(tp["stack"], tcfg, torch.tensor(x),
                                 positions=torch.tensor(pos), remat=remat)
    assert cache is None
    _close_scaled(y, jy, TOL)
    for name in ("moe_aux", "moe_z"):
        _close(a[name], ja[name], TOL)
    assert float(a["moe_aux"]) > 0.99 * tcfg.body_repeats


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, remat):
    """ce + router_aux_weight * moe_aux + router_z_weight * moe_z, its
    metrics and the gradients of every leaf."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens = _tokens((2, 32), tcfg.vocab_size, 1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(tokens)},
                             remat=remat), has_aux=True))(jp)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, m = TT.lm_loss(tree.unflatten(tp, leaves), tcfg,
                         {"tokens": torch.tensor(tokens)}, remat=remat)
    grads = tree.unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    _close(loss, jloss, LOSS_TOL)
    assert set(m) == {"ce", "moe_aux", "moe_z"} == set(jm)
    for name in m:
        _close(m[name], jm[name], LOSS_TOL)
    mc = tcfg.moe
    _close(loss, (m["ce"] + mc.router_aux_weight * m["moe_aux"]
                  + mc.router_z_weight * m["moe_z"]).detach(), 1e-6)
    _tree_close(grads, jgrads, GRAD_TOL)


# Left-pad rows route and take capacity slots before the real tokens, so a
# pad row's attention output (the mean of V over the prompt's keys: it sees
# no key) decides which real tokens drop. Every path, ragged or not, is held
# to the reference at the config's capacity.
ROUTE_CASES = [(False, True), (True, False), (True, True)]


@pytest.mark.parametrize("use_kernels,ragged", ROUTE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_route_and_match_reference(arch, use_kernels,
                                                      ragged):
    """Prefill (left-padded ragged or not), then two decode steps (every
    row at one position, then per-row positions): the routing of every MoE
    layer first, then the logits within 1e-4. The reference runs eagerly,
    on its plain path (the port's kernel structure computes the same
    function)."""
    jcfg, tcfg, jp, tp = _model(arch)
    P, total = 12, 16
    lens = (12, 5, 9) if ragged else (12, 12, 12)
    toks = _ragged(P, lens, tcfg.vocab_size, 1)
    off = (P - np.array(lens)).astype(np.int32) if ragged else None
    joff = None if off is None else jnp.asarray(off)
    toff = None if off is None else torch.tensor(off)
    layout = "head" if use_kernels else "seq"
    nxt = [_tokens((3, 1), tcfg.vocab_size, s) for s in (2, 3)]
    steps = (P, np.array([P + 1, P + 1, P + 1], np.int32))

    def reference():
        """The reference's prefill, then its two decode steps: (routing
        log, logits) of each. It does not depend on use_kernels: once per
        (arch, ragged)."""
        jc = JT.init_cache(jcfg, 3, total, dtype=jnp.float32, layout="seq")
        out = []
        jlog = []
        with _reference_routing(jlog):
            jl, jc = JT.prefill_forward(jp, jcfg, jnp.asarray(toks), jc,
                                        offsets=joff)
        out.append((jlog, jl))
        for pos, tok in zip(steps, nxt):
            jlog = []
            with _reference_routing(jlog):
                jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                        jnp.asarray(pos, jnp.int32),
                                        offsets=joff)
            out.append((jlog, jl))
        return out

    (jlog, jl), *jsteps = _reference(("route", arch, ragged), reference)
    tc = TT.init_cache(tcfg, 3, total, layout=layout, device=CPU)
    tlog = []
    with _port_routing(tlog):
        tl, tc = TT.prefill_forward(tp, tcfg, torch.tensor(toks), tc,
                                    use_kernels=use_kernels,
                                    offsets=toff)
    n_moe = sum(s.ff == "moe" for s in tcfg.layers)
    assert len(tlog) == n_moe
    _check_routing(tlog, jlog, f"{arch} prefill")
    _close(tl, jl, LOGIT_TOL)
    for pos, tok, (jlog, jl) in zip(steps, nxt, jsteps):
        tlog = []
        tpos = pos if isinstance(pos, int) else torch.tensor(pos)
        with _port_routing(tlog):
            tl, tc = TT.decode_step(tp, tcfg, torch.tensor(tok), tc, tpos,
                                    use_kernels=use_kernels,
                                    offsets=toff)
        # decode folds the batch: one sequence of 3 tokens a layer
        assert all(r["topi"].shape[:2] == (1, 3) for r in tlog)
        _check_routing(tlog, jlog, f"{arch} decode")
        _close(tl, jl, LOGIT_TOL)


GEN_CASES = [(False, False, 1.25), (True, False, 1.25), (False, True, 1.25),
             (True, True, 1.25)]


@pytest.mark.parametrize("use_kernels,ragged,cf", GEN_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, use_kernels, ragged, cf):
    """Greedy tokens equal to ``repro.serving.generate`` at capacity factor
    1.25, where assignments drop (left pads first, see ROUTE_CASES)."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    if ragged:
        P, lens = 14, (4, 14, 9)
        prompts = _ragged(P, lens, tcfg.vocab_size, 3)
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=6,
                         prompt_lens=jnp.array(lens, jnp.int32),
                         use_kernels=use_kernels)
        tout = generate(tp, tcfg, prompts, max_new_tokens=6,
                        prompt_lens=lens, use_kernels=use_kernels,
                        device=CPU)
    else:
        prompts = _tokens((3, 10), tcfg.vocab_size, 1)
        jout = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=8,
                         use_kernels=use_kernels)
        tout = generate(tp, tcfg, prompts, max_new_tokens=8,
                        use_kernels=use_kernels, device=CPU)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def _trace(cfg, n, cls, seed=0):
    """Staggered arrivals, prompts of 4 or 8 tokens, 6 new tokens each."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = int(r.choice([4, 8]))
        prompt = r.randint(0, cfg.vocab_size, size=(L,)).astype("int32")
        out.append(cls(id=i, prompt=prompt, max_new_tokens=6,
                       arrival=0.9 * i))
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_matches_reference(use_kernels):
    """Five requests through three slots of a paged pool: the completions
    equal the reference engine's. Every slot decodes every step, idle ones
    too, so idle slots take decode capacity in both."""
    jcfg, tcfg, jp, tp = _model("qwen2-moe-a2.7b")
    kw = dict(num_slots=3, max_len=16, page_size=8, layout="paged",
              use_kernels=use_kernels)
    jcomps = JEngine(jp, jcfg, **kw).run(_trace(jcfg, 5, JRequest))
    eng = ContinuousEngine(tp, tcfg, device=CPU, **kw)
    comps = eng.run(_trace(tcfg, 5, Request))
    got = {i: list(map(int, c.tokens)) for i, c in comps.items()}
    want = {i: list(map(int, c.tokens)) for i, c in jcomps.items()}
    assert sorted(got) == list(range(5)) and got == want
    st = eng.stats()
    assert st["raw_tokens"] == 3 * st["steps"] + 5


def test_train_step_matches_reference():
    """One momentum-SGD step (noise off) from the same parameters: loss
    1e-5, the step's moe_aux/moe_z metrics, and the parameters 1e-4."""
    jcfg, tcfg, jp, tp = _model("qwen2-moe-a2.7b")
    tokens = _tokens((2, 24), tcfg.vocab_size, 9)
    jlb = JLargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    jstep = jax.jit(jmake_lm_train_step(jcfg, jlb, JRegime(
        base_lr=0.1, total_steps=10, drop_every=10)))
    step = TR.make_lm_train_step(tcfg, lb, Regime(base_lr=0.1,
                                                  total_steps=10,
                                                  drop_every=10))
    jp2, _, jm = jstep(jp, jsgd.init(jp), {"tokens": jnp.asarray(tokens)},
                       jnp.int32(0), jax.random.PRNGKey(2))
    tp2, _, m = step(tp, sgd.init(tp), {"tokens": torch.tensor(tokens)}, 0)
    for name in ("loss", "ce", "moe_aux", "moe_z"):
        _close(m[name], jm[name], LOSS_TOL)
    _tree_close(tp2, jp2, GRAD_TOL)
