"""The LM training slice held to the JAX package on the CPU, in f32 (its
kernels: tests/test_torch_lm_kernels.py).

Reduced qwen3-1.7b (B=2, S=32) with the reference's parameters
carried across by ``convert.lm_to_torch``: ``lm_loss`` and its gradients,
one ``make_lm_train_step`` step (sgd and adam, with and without the kernels'
structure; loss 1e-5, params 1e-4 as tests/test_kernels.py holds the
reference's own kernel path), the chunked CE, remat, a sliding-window
variant through the block-local attention, and ``train_lm``'s per-step
losses (1e-4) with ``rows == batch_size`` so that the two packages'
shuffles take the same rows. Noise draws cannot match across frameworks:
the parity steps run without noise, and one test drives the noise path.
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
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.train.trainer import make_lm_train_step as jmake_lm_train_step
from repro.train.trainer import train_lm as jtrain_lm
from repro_torch import convert, tree
from repro_torch.configs import LayerSpec, get_config
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.data import lm_sequences, token_lm
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.optim import adam, sgd
from repro_torch.train import trainer as TR

CPU = "cpu"


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the slice: reduced qwen3-1.7b
# ---------------------------------------------------------------------------

B_, S_ = 2, 32


def _cfgs(**overrides):
    j = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                            dtype="float32", **overrides)
    t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                            dtype="float32", **overrides)
    return j, t


def _model(seed=0, **overrides):
    jcfg, tcfg = _cfgs(**overrides)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    return _model()


def _batch(vocab, seed=1, B=B_, S=S_):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _tree_close(got, want, tol):
    got_l = tree.leaves(convert.lm_to_numpy(got))
    want_l = jax.tree.leaves(jax.device_get(want))
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        _close(a, b, tol)


def _loss_and_grads(tp, tcfg, tokens, **kw):
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    loss, metrics = TT.lm_loss(tree.unflatten(tp, leaves), tcfg,
                               {"tokens": torch.tensor(tokens)}, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, tree.unflatten(tp, list(grads))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_loss_and_grads_match_reference(model, use_kernels):
    jcfg, tcfg, jp, tp = model
    tokens = _batch(tcfg.vocab_size)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(tokens)},
                             use_kernels=use_kernels), has_aux=True)(jp)
    loss, metrics, grads = _loss_and_grads(tp, tcfg, tokens,
                                           use_kernels=use_kernels)
    _close(loss, jloss, 1e-5)
    _close(metrics["ce"], jm["ce"], 1e-5)
    _tree_close(grads, jgrads, 1e-4)


def test_forward_logits_match_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = _batch(tcfg.vocab_size, seed=2)
    want, _ = JT.forward(jp, jcfg, jnp.asarray(tokens))
    for uk in (False, True):
        got, _ = TT.forward(tp, tcfg, torch.tensor(tokens), use_kernels=uk)
        assert got.shape == (B_, S_, tcfg.padded_vocab)
        _close(got, want, 1e-4)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_train_step_matches_reference(model, use_kernels, optimizer):
    """One step from the same params and optimizer state (noise off):
    loss 1e-5 and updated params 1e-4, the bar of
    tests/test_kernels.py:test_lm_train_step_kernel_path_matches."""
    jcfg, tcfg, jp, tp = model
    tokens = _batch(tcfg.vocab_size, seed=3)
    jlb = JLargeBatchConfig(batch_size=B_, base_batch_size=B_, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=B_, base_batch_size=B_, grad_clip=1.0)
    jreg = JRegime(base_lr=0.01, total_steps=10, drop_every=10)
    reg = Regime(base_lr=0.01, total_steps=10, drop_every=10)
    jinit = jadam.init if optimizer == "adam" else jsgd.init
    jopt = jinit(jp)
    jstep = jax.jit(jmake_lm_train_step(jcfg, jlb, jreg,
                                        use_kernels=use_kernels,
                                        optimizer=optimizer))
    jp2, jopt2, jm = jstep(jp, jopt, {"tokens": jnp.asarray(tokens)},
                           jnp.int32(0), jax.random.PRNGKey(2))
    opt = convert.lm_opt_state_to_torch(jax.device_get(jopt), tcfg, CPU)
    step = TR.make_lm_train_step(tcfg, lb, reg, use_kernels=use_kernels,
                                 optimizer=optimizer)
    tp2, opt2, m = step(tp, opt, {"tokens": torch.tensor(tokens)}, 0)
    _close(m["loss"], jm["loss"], 1e-5)
    _close(m["grad_norm"], jm["grad_norm"], 1e-4)
    if optimizer == "sgd":
        _tree_close(tp2, jp2, 1e-4)
        _tree_close(opt2.momentum, jopt2.momentum, 1e-4)
        return
    # Adam's first step moves each parameter by lr * g / (|g| + 1e-8): where
    # a gradient is ~1e-8 (10^5 below the median here) the two packages'
    # f32 summation orders give it either sign, and the parameter moves by
    # +-lr. So the step is held in well-conditioned parts: its moments to
    # the reference step's, and its parameters to the reference's
    # adam.update applied to this step's own gradients (which
    # test_lm_loss_and_grads_match_reference holds to the reference's).
    _tree_close(opt2.mu, jopt2.mu, 1e-4)
    _tree_close(opt2.nu, jopt2.nu, 1e-4)
    assert int(opt2.step) == int(jopt2.step) == 1
    _, _, g = _loss_and_grads(tp, tcfg, tokens, use_kernels=use_kernels)
    jg = jax.tree.unflatten(jax.tree.structure(jp), [
        jnp.asarray(a) for a in tree.leaves(convert.lm_to_numpy(g))])
    want, _, _ = jadam.update(jg, jopt, jp, lr=jreg.lr_at(0), grad_clip=1.0)
    _tree_close(tp2, want, 1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_chunked_ce_matches_dense_and_reference(model, use_kernels):
    jcfg, tcfg, jp, tp = model
    tokens = _batch(tcfg.vocab_size, seed=4)
    chunk = tcfg.padded_vocab // 4
    dense, _, gd = _loss_and_grads(tp, tcfg, tokens, use_kernels=use_kernels)
    chunked, _, gc = _loss_and_grads(tp, tcfg, tokens, use_kernels=use_kernels,
                                     ce_chunk=chunk)
    jloss, _ = JT.lm_loss(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                          ce_chunk=chunk)
    _close(chunked, dense.detach().numpy(), 1e-5)
    _close(chunked, jloss, 1e-5)
    for a, b in zip(tree.leaves(gc), tree.leaves(gd)):
        _close(a, b.numpy(), 1e-4)


def test_chunked_ce_masks_the_padded_vocab():
    """A padded vocab (vocab_size < padded_vocab): chunks past the real
    vocabulary are masked to -1e30, as in the dense CE and the reference."""
    jcfg, tcfg, jp, tp = _model(vocab_size=500)
    assert tcfg.padded_vocab > tcfg.vocab_size
    tokens = _batch(tcfg.vocab_size, seed=5)
    chunk = tcfg.padded_vocab // 2
    dense, _, _ = _loss_and_grads(tp, tcfg, tokens)
    chunked, _, _ = _loss_and_grads(tp, tcfg, tokens, ce_chunk=chunk)
    jloss, _ = JT.lm_loss(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                          ce_chunk=chunk)
    _close(dense, jloss, 1e-5)
    _close(chunked, jloss, 1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_remat_matches_no_remat(model, use_kernels):
    _, tcfg, _, tp = model
    tokens = _batch(tcfg.vocab_size, seed=6)
    l0, _, g0 = _loss_and_grads(tp, tcfg, tokens, use_kernels=use_kernels)
    l1, _, g1 = _loss_and_grads(tp, tcfg, tokens, use_kernels=use_kernels,
                                remat=True)
    _close(l1, l0.detach().numpy(), 1e-6)
    for a, b in zip(tree.leaves(g1), tree.leaves(g0)):
        _close(a, b.numpy(), 1e-6)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sliding_window_variant_matches_reference(use_kernels):
    """swa blocks with a window of 8 over S=32 (> 2 * window): the plain
    path takes the block-local attention (``_local_attention``), the kernel
    path the windowed RoPE flash kernel; both equal the reference's."""
    jcfg, tcfg, jp, tp = _model(
        seed=7, sliding_window=8,
        body_pattern=(LayerSpec(mixer="swa", ff="dense"),))
    tokens = _batch(tcfg.vocab_size, seed=8)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(tokens)},
                             use_kernels=use_kernels), has_aux=True)(jp)
    loss, _, grads = _loss_and_grads(tp, tcfg, tokens,
                                     use_kernels=use_kernels)
    _close(loss, jloss, 1e-5)
    _tree_close(grads, jgrads, 1e-4)


def test_train_lm_losses_match_reference():
    """``train_lm`` over rows == batch_size (both packages' shuffles take
    every row, in an order the mean CE does not see), from the reference's
    own initial parameters: per-step losses within 1e-4."""
    jcfg, tcfg = _cfgs()
    stream = token_lm(0, vocab_size=tcfg.vocab_size, n_tokens=4 * 33)
    rows = lm_sequences(stream, 33)
    assert rows.shape == (4, 33)
    jlb = JLargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
    jreg = JRegime(base_lr=0.05, total_steps=4, drop_every=2)
    reg = Regime(base_lr=0.05, total_steps=4, drop_every=2)
    jout = jtrain_lm(jcfg, jlb, jreg, rows, seed=0, eval_every=1)
    init_key = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    tp = convert.lm_to_torch(jax.device_get(JT.init_params(init_key, jcfg)),
                             tcfg, CPU)
    out = TR.train_lm(tcfg, lb, reg, rows, seed=0, eval_every=1, params=tp,
                      device=CPU)
    assert out["steps"] == jout["steps"] == 4
    want = jout["history"]["train_loss"]
    got = out["history"]["train_loss"]
    _close(np.asarray(got), np.asarray(want), 1e-4)
    assert got[-1] < got[0]


def test_token_lm_matches_reference():
    from repro.data.synthetic import lm_sequences as jseq
    from repro.data.synthetic import token_lm as jtok
    a = token_lm(3, vocab_size=97, n_tokens=500)
    np.testing.assert_array_equal(a, jtok(3, vocab_size=97, n_tokens=500))
    np.testing.assert_array_equal(lm_sequences(a, 7), jseq(a, 7))


def test_noise_path_runs(model):
    """Gradient noise (ghost_noise > 0) draws from the step's generator:
    finite, repeatable for one seed, and a different step than no noise."""
    _, tcfg, _, tp = model
    tokens = {"tokens": torch.tensor(_batch(tcfg.vocab_size, seed=9))}
    reg = Regime(base_lr=0.01, total_steps=10, drop_every=10)
    noisy = TR.make_lm_train_step(
        tcfg, LargeBatchConfig(batch_size=8, base_batch_size=2,
                               ghost_noise=0.5), reg)
    quiet = TR.make_lm_train_step(
        tcfg, LargeBatchConfig(batch_size=8, base_batch_size=2), reg)
    outs = [noisy(tp, sgd.init(tp), tokens, 0,
                  torch.Generator().manual_seed(11))[0] for _ in range(2)]
    plain = quiet(tp, sgd.init(tp), tokens, 0)[0]
    for a, b, c in zip(*(tree.leaves(o) for o in outs + [plain])):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    assert any(not torch.equal(a, c) for a, c in
               zip(tree.leaves(outs[0]), tree.leaves(plain)))
    with pytest.raises(ValueError):
        noisy(tp, sgd.init(tp), tokens, 0)          # noise needs a generator


def test_unported_options_raise(model):
    """The mesh options' errors, as the reference's: a mesh needs the
    params tree, tp/fsdp need a mesh; ``seq_parallel`` is a layout hint
    (accepted). ``train_lm`` over the one-process host mesh takes the
    plain run's steps (tests/test_torch_parallel.py holds the multi-rank
    ones)."""
    _, tcfg, _, tp = model
    lb = LargeBatchConfig(batch_size=2, base_batch_size=2)
    reg = Regime(base_lr=0.01, total_steps=2, drop_every=2)
    for kw, match in (({"mesh": object()}, "needs the params"),
                      ({"tp": True}, "need a mesh"),
                      ({"fsdp": True}, "need a mesh")):
        with pytest.raises(ValueError, match=match):
            TR.make_lm_train_step(tcfg, lb, reg, **kw)
    TR.make_lm_train_step(tcfg, lb, reg, seq_parallel=True)
    with pytest.raises(ValueError):
        TR.make_lm_train_step(tcfg, lb, reg, optimizer="lion")
    rows = np.random.RandomState(11).randint(0, tcfg.vocab_size, (2, 9))
    runs = [TR.train_lm(tcfg, lb, reg, rows, params=tp, mesh=mesh,
                        eval_every=1, device=CPU)["history"]["train_loss"]
            for mesh in (None, make_host_mesh(CPU))]
    assert len(runs[0]) == 2
    _close(np.asarray(runs[1]), np.asarray(runs[0]), 1e-6)
    ev = TR.make_lm_eval_step(tcfg)(tp, {"tokens": torch.tensor(
        _batch(tcfg.vocab_size, seed=10))})
    assert ev.shape == () and torch.isfinite(ev)
    st = adam.init(tp)
    assert int(st.step) == 0 and len(tree.leaves(st.mu)) == len(
        tree.leaves(tp))
