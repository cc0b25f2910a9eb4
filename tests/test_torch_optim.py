"""The port's optimizer and schedule held to the JAX package: ``sgd.update``
(momentum, nesterov, weight decay on every leaf, clipping), gradient noise
(the reference's own draws injected, and moments), ``Regime.lr_at`` in
float32, ``adapt_regime``, ``presets`` and the diffusion tracker."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.core import diffusion as jdiff
from repro.core import large_batch as jlb
from repro.core import lr_scaling as jlr
from repro.core import noise as jnoise
from repro.core import regime as jreg
from repro.core.clipping import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro_torch import convert, tree
from repro_torch.core import diffusion as tdiff
from repro_torch.core import large_batch as tlb
from repro_torch.core import lr_scaling as tlr
from repro_torch.core import noise as tnoise
from repro_torch.core import regime as treg
from repro_torch.core.clipping import clip_by_global_norm as tclip
from repro_torch.optim import sgd as tsgd

TOL = 1e-5


def _tree(seed, scale=1.0):
    """A small parameter-shaped tree (dict keys out of sorted order)."""
    rng = np.random.RandomState(seed)
    return {"stem": {"w": scale * rng.randn(3, 3, 2, 4).astype(np.float32),
                     "norm": {"gamma": rng.rand(4).astype(np.float32) + 0.5,
                              "beta": scale * rng.randn(4).astype(np.float32)}},
            "layers": [{"w": scale * rng.randn(5, 3).astype(np.float32),
                        "b": scale * rng.randn(3).astype(np.float32)}],
            "out": {"b": scale * rng.randn(2).astype(np.float32)}}


def _close(t_tree, j_tree, tol=TOL):
    got = jax.tree.leaves(convert.to_numpy(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
@pytest.mark.parametrize("grad_clip", [0.0, 0.5, 1e3])
def test_sgd_update_matches_reference(nesterov, weight_decay, grad_clip):
    p, g1, g2 = _tree(0), _tree(1), _tree(2)
    jstate = jsgd.init(p)
    tp = convert.to_torch(p, device="cpu")
    tstate = tsgd.init(tp)
    jparams = p
    for step, g in enumerate((g1, g2)):
        lr = jreg.Regime(0.3, 10, 1).lr_at(step)
        jparams, jstate, jm = jsgd.update(
            g, jstate, jparams, lr=lr, momentum=0.9, nesterov=nesterov,
            weight_decay=weight_decay, grad_clip=grad_clip)
        tp, tstate, tm = tsgd.update(
            convert.to_torch(g, device="cpu"), tstate, tp,
            lr=treg.Regime(0.3, 10, 1).lr_at(step), momentum=0.9,
            nesterov=nesterov, weight_decay=weight_decay,
            grad_clip=grad_clip)
        _close(tp, jparams)
        _close(tstate.momentum, jstate.momentum)
        assert int(tstate.step) == int(jstate.step)
        assert set(tm) == set(jm)
        if grad_clip:
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=TOL)


def test_weight_decay_reaches_every_leaf():
    """Zero gradients: every leaf, gamma and beta included, shrinks."""
    p = _tree(4)
    zeros = jax.tree.map(np.zeros_like, p)
    tp = convert.to_torch(p, device="cpu")
    new, _, _ = tsgd.update(convert.to_torch(zeros, device="cpu"),
                            tsgd.init(tp), tp, lr=torch.tensor(0.5),
                            weight_decay=0.1)
    for a, b in zip(tree.leaves(new), tree.leaves(tp)):
        torch.testing.assert_close(a, b * 0.95)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_matches_reference(max_norm):
    g = _tree(5, scale=3.0)
    tg, tn = tclip(convert.to_torch(g, device="cpu"), max_norm)
    jg, jn = jclip(g, max_norm)
    _close(tg, jg)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)


@pytest.mark.parametrize("sigma", [0.0, 0.5, 3.0])
def test_multiplicative_noise_with_reference_draws(sigma):
    """Feed the port the exact normals jax.random draws inside
    ``repro.core.noise.multiplicative_noise_grads``."""
    g = _tree(6)
    key = jax.random.PRNGKey(11)
    leaves, treedef = jax.tree.flatten(g)
    z = [np.asarray(jax.random.normal(r, l.shape, jnp.float32))
         for r, l in zip(jax.random.split(key, len(leaves)), leaves)]
    want = jnoise.multiplicative_noise_grads(key, g, sigma)
    got = tnoise.apply_multiplicative_noise(
        convert.to_torch(g, device="cpu"),
        convert.to_torch(jax.tree.unflatten(treedef, z), device="cpu"), sigma)
    _close(got, want)


def test_multiplicative_noise_unbiased_and_scaled():
    gen = torch.Generator().manual_seed(0)
    grads = {"w": torch.ones(20000), "b": 2.0 * torch.ones(5000)}
    noisy = tnoise.multiplicative_noise_grads(gen, grads, 0.5)
    assert float(noisy["w"].mean()) == pytest.approx(1.0, abs=0.02)
    assert float(noisy["w"].std()) == pytest.approx(0.5, rel=0.05)
    assert float(noisy["b"].std()) == pytest.approx(1.0, rel=0.05)


def test_ghost_noise_matches_covariance():
    G, sigma = 8, 0.3
    gen = torch.Generator().manual_seed(1)
    draws = np.array([
        float(tnoise.ghost_noise_grads(gen, {"g": torch.ones(G, 4)},
                                       sigma)["g"][0])
        for _ in range(2000)])
    assert draws.mean() == pytest.approx(1.0, abs=0.03)
    assert draws.std() == pytest.approx(sigma, rel=0.1)


def test_sgd_noise_needs_a_generator():
    tp = convert.to_torch(_tree(0), device="cpu")
    with pytest.raises(ValueError):
        tsgd.update(tp, tsgd.init(tp), tp, lr=torch.tensor(0.1),
                    noise_sigma=0.5)


REGIMES = [dict(base_lr=0.1, total_steps=100, drop_every=30),
           dict(base_lr=0.35355339, total_steps=700, drop_every=7,
                drop_factor=0.1, warmup_steps=5, min_lr=1e-6),
           dict(base_lr=1.7, total_steps=50, drop_every=3, drop_factor=0.5)]


@pytest.mark.parametrize("kw", REGIMES)
def test_lr_at_matches_reference_in_float32(kw):
    jr, tr = jreg.Regime(**kw), treg.Regime(**kw)
    for step in range(0, kw["total_steps"], 3):
        got = tr.lr_at(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jr.lr_at(step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("rule", ["sqrt", "linear", "none"])
@pytest.mark.parametrize("ra", [False, True])
def test_adapt_regime_and_scaling_match_reference(rule, ra):
    kw = dict(batch_size=4096, base_batch_size=128, lr_rule=rule,
              regime_adaptation=ra)
    small = dict(base_lr=0.1, total_steps=300, drop_every=90, warmup_steps=4)
    got = treg.adapt_regime(treg.Regime(**small), **kw)
    want = jreg.adapt_regime(jreg.Regime(**small), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tlr.scale_lr(0.1, 4096, 128, rule) == jlr.scale_lr(0.1, 4096,
                                                              128, rule)
    assert tlr.noise_sigma(4096, 128, 0.7) == jlr.noise_sigma(4096, 128, 0.7)
    assert treg.epochs_to_steps(3, 50000, 4096) == \
        jreg.epochs_to_steps(3, 50000, 4096)


@pytest.mark.parametrize("large,small,ghost", [(4096, 128, 128),
                                               (1024, 64, 32)])
def test_presets_match_reference(large, small, ghost):
    got, want = tlb.presets(large, small, ghost), jlb.presets(large, small,
                                                              ghost)
    assert list(got) == list(want)
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
        assert got[k].effective_noise_sigma() == \
            want[k].effective_noise_sigma()
        assert got[k].effective_lr(0.1) == want[k].effective_lr(0.1)


def test_diffusion_tracker_matches_reference():
    p0, p1, p2 = _tree(7), _tree(8), _tree(9)
    jt = jdiff.DiffusionTracker(p0)
    tt = tdiff.DiffusionTracker(convert.to_torch(p0, device="cpu"))
    for i, p in enumerate((p1, p2, p0), start=1):
        jt.record(i, p)
        tt.record(i, convert.to_torch(p, device="cpu"))
    np.testing.assert_allclose(tt.distances, jt.distances, rtol=TOL)
    assert tt.steps == jt.steps
    steps = [1, 2, 4, 8, 16, 32, 64]
    d = [math.log(s) * 0.7 + 0.1 for s in steps]
    assert tdiff.fit_log_diffusion(steps, d) == \
        pytest.approx(jdiff.fit_log_diffusion(steps, d))
    assert tdiff.fit_power_diffusion(steps, d) == \
        pytest.approx(jdiff.fit_power_diffusion(steps, d))
