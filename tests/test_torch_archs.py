"""The port's remaining decoder configurations held to the JAX package on the
CPU, in f32: reduced jamba-v0.1-52b (Mamba, attention and MoE in one
stack), phi3-medium-14b, gemma3-27b (five sliding-window layers to a
global one, qk-norm, a local tail) and h2o-danube-3-4b (sliding-window
attention), and every new configuration field by field.

- jamba: the ragged prefill's and two decode steps' routing, layer by
  layer, before the logits (the harness of tests/test_torch_moe.py);
- every model: ``forward`` logits, ``lm_loss`` and the gradients of every
  leaf with ``remat`` both ways, greedy ragged ``generate`` with and
  without kernels (the plain versions on the CPU); gemma3's prompts and
  decodes run past its reduced window of 16, so the swa layers' rings wrap;
- jamba through ``ContinuousEngine`` (paged attention for its attention
  layer, SSM states for the rest, in one engine) against the reference
  engine's completions.

Each reference result is computed once, on the reference's plain path
(its kernel path computes the same function; remat changes no value),
and held against both of the port's paths.

Tolerances are the reference tests': loss 1e-5, grads 1e-4, logits 1e-4,
tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import cpu_share  # noqa: F401 (autouse)
from test_torch_moe import _check_routing, _port_routing, _reference_routing

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import list_archs as jlist_archs
from repro.models import transformer as JT
from repro.serving import ContinuousEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import generate as jgenerate
from repro_torch import convert, tree
from repro_torch.configs import get_config, list_configs
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousEngine, Request, generate

CPU = "cpu"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
NEW = ("seamless-m4t-large-v2", "llama-3.2-vision-11b", "jamba-v0.1-52b",
       "phi3-medium-14b", "gemma3-27b", "h2o-danube-3-4b")
ARCHS = ("jamba-v0.1-52b", "phi3-medium-14b", "gemma3-27b",
         "h2o-danube-3-4b")


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _ragged(P, lens, vocab, seed):
    full = _tokens((len(lens), P), vocab, seed)
    return np.where(np.arange(P)[None] >= P - np.array(lens)[:, None], full,
                    0).astype(np.int32)


_MODELS = {}
_REFERENCE = {}


def _reference(key, fn):
    """``fn()`` once per ``key``: a reference result the cases share."""
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


def _model(arch):
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    for name in (arch, arch + "-reduced"):
        j, t = jget_config(name), get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_registry_covers_the_reference():
    assert set(jlist_archs()) <= set(list_configs())
    for name in jlist_archs():
        assert get_config(name + "-reduced").name == name + "-reduced"


def test_reduced_shapes_exercise_the_paths():
    """What the tests below rely on: jamba's reduced stack holds ssm, attn,
    dense and MoE layers; gemma3's ends in a local layer; every reduced
    head width is 64, and h2o-danube's full one is 120 (that every
    registry width is one the kernels take is the kernel-tile contract of
    repro_torch.analysis; tests/test_torch_head_widths.py holds 112 and
    120 to the reference)."""
    jamba = get_config("jamba-v0.1-52b-reduced")
    assert {(s.mixer, s.ff) for s in jamba.layers} == {
        ("ssm", "dense"), ("ssm", "moe"), ("attn", "dense")}
    gemma = get_config("gemma3-27b-reduced")
    assert gemma.sliding_window == 16 and gemma.layers[-1].mixer == "swa"
    assert get_config("h2o-danube-3-4b").head_dim == 120
    assert all(get_config(a + "-reduced").head_dim == 64 for a in ARCHS)


def test_jamba_prefill_and_decode_route_and_match_reference():
    """Ragged prefill, then a decode step with every row at one position
    and one with per-row positions: each MoE layer's routing first (topi,
    then slot, keep, C), then the logits within 1e-4, through the plain
    path and the kernels' (plain versions here)."""
    jcfg, tcfg, jp, tp = _model("jamba-v0.1-52b")
    P, total, lens = 12, 16, (12, 5, 9)
    toks = _ragged(P, lens, tcfg.vocab_size, 1)
    off = (P - np.array(lens)).astype(np.int32)
    n_moe = sum(s.ff == "moe" for s in tcfg.layers)
    jc = JT.init_cache(jcfg, 3, total, dtype=jnp.float32, layout="seq")
    jlog = []
    with _reference_routing(jlog):
        jl, jc = JT.prefill_forward(jp, jcfg, jnp.asarray(toks), jc,
                                    offsets=jnp.asarray(off))
    jsteps = []
    nxt = [_tokens((3, 1), tcfg.vocab_size, s) for s in (2, 3)]
    for pos, tok in zip((P, np.full(3, P + 1, np.int32)), nxt):
        log = []
        with _reference_routing(log):
            lg, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                    jnp.asarray(pos, jnp.int32),
                                    offsets=jnp.asarray(off))
        jsteps.append((log, lg))
    for use_kernels in (False, True):
        tc = TT.init_cache(tcfg, 3, total, device=CPU,
                           layout="head" if use_kernels else "seq")
        tlog = []
        with _port_routing(tlog):
            tl, tc = TT.prefill_forward(tp, tcfg, torch.tensor(toks), tc,
                                        use_kernels=use_kernels,
                                        offsets=torch.tensor(off))
        assert len(tlog) == n_moe
        _check_routing(tlog, jlog, f"jamba prefill kernels={use_kernels}")
        _close(tl, jl, LOGIT_TOL)
        for (pos, tok), (log, lg) in zip(
                zip((P, torch.full((3,), P + 1)), nxt), jsteps):
            tlog = []
            with _port_routing(tlog):
                tl, tc = TT.decode_step(tp, tcfg, torch.tensor(tok), tc,
                                        pos, use_kernels=use_kernels,
                                        offsets=torch.tensor(off))
            _check_routing(tlog, log, f"jamba decode kernels={use_kernels}")
            _close(tl, lg, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    """Logits over 40 tokens (past gemma3's reduced window of 16)."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens((2, 40), tcfg.vocab_size, 5)
    jl, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(jp,
                                                       jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = TT.forward(tp, tcfg, torch.tensor(toks))
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, remat):
    """The loss (with jamba's router losses), its metrics and the
    gradients of every leaf."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens((2, 40), tcfg.vocab_size, 6)
    (jloss, jm), jgrads = _reference(("lm_loss", arch), lambda: (
        jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(
            p, jcfg, {"tokens": jnp.asarray(toks)}), has_aux=True))(jp)))
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, m = TT.lm_loss(tree.unflatten(tp, leaves), tcfg,
                         {"tokens": torch.tensor(toks)}, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss, LOSS_TOL)
    for name in m:
        _close(m[name], jm[name], LOSS_TOL)
    want = jax.tree.leaves(jax.device_get(jgrads))
    got = tree.leaves(convert.lm_to_numpy(tree.unflatten(tp, list(grads))))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, use_kernels):
    """Greedy tokens of left-padded ragged prompts equal to
    ``repro.serving.generate``'s; 40-token prompts and 20 new tokens wrap
    the rings of gemma3's and h2o-danube's window layers."""
    jcfg, tcfg, jp, tp = _model(arch)
    P, lens = 40, (40, 23, 9)
    prompts = _ragged(P, lens, tcfg.vocab_size, 7)
    jout = _reference(("generate", arch), lambda: np.asarray(jgenerate(
        jp, jcfg, jnp.asarray(prompts), max_new_tokens=20,
        prompt_lens=jnp.array(lens, jnp.int32))))
    tout = generate(tp, tcfg, prompts, max_new_tokens=20, prompt_lens=lens,
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
def test_jamba_engine_matches_reference(use_kernels):
    """Five requests through three slots: the attention layer's pages and
    the SSM layers' states in one engine; the completions equal the
    reference engine's (idle slots take MoE decode capacity in both)."""
    jcfg, tcfg, jp, tp = _model("jamba-v0.1-52b")
    kw = dict(num_slots=3, max_len=16, page_size=8, layout="paged")
    want = _reference("engine", lambda: {
        i: list(map(int, c.tokens)) for i, c in JEngine(
            jp, jcfg, use_kernels=False, **kw).run(
                _trace(jcfg, 5, JRequest)).items()})
    eng = ContinuousEngine(tp, tcfg, device=CPU, use_kernels=use_kernels,
                           **kw)
    comps = eng.run(_trace(tcfg, 5, Request))
    got = {i: list(map(int, c.tokens)) for i, c in comps.items()}
    assert sorted(got) == list(range(5)) and got == want
    kinds = {k for _, c in TB.each_layer(eng.cache, tcfg) for k in c}
    assert kinds == {"attn", "ssm"}
