"""The port's int8 blockwise momentum, batching pipeline and Appendix-B
probe against the JAX package's, on the CPU.

- ``sgd._quantize_int8`` / ``_dequantize_int8`` bit-equal to the
  reference's (ragged last axes, leading dims kept); three SGD steps with
  int8 momentum within 1e-6; one LM train step with int8 momentum
  (reduced qwen3-1.7b) within 1e-4; the mesh step refusing int8, as the
  reference's does;
- ``epoch_batches`` and ``minibatch_stream`` bit-equal;
- ``_probe_from_draws`` fed the reference's own draws against
  ``random_potential_probe`` within 1e-5.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.registry import get_config as jget_config
from repro.core import LargeBatchConfig as JLB
from repro.core import Regime as JRegime
from repro.core.diffusion import random_potential_probe as jprobe
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro.train.trainer import make_lm_train_step as jmake_step
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.core.diffusion import _probe_from_draws, random_potential_probe
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import sgd
from repro_torch.train.trainer import make_lm_train_step

CPU = "cpu"


def _q_shapes():
    return [(3, 300), (513,), (2, 3, 256), (4, 7), (1, 1024)]


@pytest.mark.parametrize("shape", _q_shapes())
def test_int8_quantize_bit_equal(shape):
    x = (np.random.RandomState(len(shape)).randn(*shape) * 3).astype(
        np.float32)
    x.reshape(-1)[:5] = 0.0
    want = jax.device_get(jsgd._quantize_int8(jnp.asarray(x)))
    got = sgd._quantize_int8(torch.tensor(x))
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    back = sgd._dequantize_int8(got, x.shape, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jsgd._dequantize_int8(
        {k: jnp.asarray(v) for k, v in want.items()}, x.shape, jnp.float32)))
    assert back.shape == x.shape


def test_int8_sgd_steps_match_reference():
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(5, 300).astype(np.float32),
              "b": [rs.randn(7).astype(np.float32)]}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree.map(torch.tensor, params)
    jst = jsgd.init(jp, momentum_dtype="int8")
    tst = sgd.init(tp, momentum_dtype="int8")
    for i in range(3):
        g = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32),
                         params)
        jp, jst, _ = jsgd.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                 lr=jnp.float32(0.1), weight_decay=1e-3,
                                 momentum_dtype="int8")
        tp, tst, _ = sgd.update(tree.map(torch.tensor, g), tst, tp,
                                lr=torch.tensor(0.1), weight_decay=1e-3,
                                momentum_dtype="int8")
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(tree.leaves(tst.momentum), jax.tree.leaves(jst.momentum)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=1e-6,
                                   atol=1e-6)
    assert int(tst.step) == int(jst.step) == 3


def _lm():
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               dtype="float32", vocab_size=128)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype="float32", vocab_size=128)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.lm_to_torch(jax.device_get(jp), tcfg, CPU)


def test_int8_lm_step_matches_reference():
    jcfg, tcfg, jp, tp = _lm()
    tokens = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(
        np.int32)
    jlb = JLB(batch_size=2, base_batch_size=2, grad_clip=1.0)
    lb = LargeBatchConfig(batch_size=2, base_batch_size=2, grad_clip=1.0)
    jstep = jax.jit(jmake_step(jcfg, jlb, JRegime(base_lr=0.05,
                                                  total_steps=4,
                                                  drop_every=4),
                               momentum_dtype="int8"))
    step = make_lm_train_step(tcfg, lb, Regime(base_lr=0.05, total_steps=4,
                                               drop_every=4),
                              momentum_dtype="int8")
    jo = jsgd.init(jp, momentum_dtype="int8")
    to = sgd.init(tp, momentum_dtype="int8")
    for i in range(2):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(tokens)},
                           jnp.int32(i), jax.random.PRNGKey(i))
        tp, to, m = step(tp, to, {"tokens": torch.tensor(tokens)}, i)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-5)
    got = tree.leaves(convert.lm_to_numpy(tp))
    for a, b in zip(got, jax.tree.leaves(jax.device_get(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert to.momentum["embed"]["q"].dtype == torch.int8


def test_mesh_step_refuses_int8():
    jcfg, tcfg, jp, tp = _lm()
    lb, jlb = LargeBatchConfig(batch_size=2), JLB(batch_size=2)
    reg = dict(base_lr=0.1, total_steps=2, drop_every=2)
    with pytest.raises(NotImplementedError, match="int8"):
        jmake_step(jcfg, jlb, JRegime(**reg), mesh=jhost_mesh(), params=jp,
                   momentum_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        make_lm_train_step(tcfg, lb, Regime(**reg), mesh=make_host_mesh(CPU),
                           params=tp, momentum_dtype="int8")
    with pytest.raises(ValueError, match="need a mesh"):
        make_lm_train_step(tcfg, lb, Regime(**reg), tp=True)
    with pytest.raises(ValueError, match="needs the params"):
        make_lm_train_step(tcfg, lb, Regime(**reg), mesh=make_host_mesh(CPU))


@pytest.mark.parametrize("n,batch,drop", [(100, 32, True), (100, 32, False),
                                          (64, 16, True)])
def test_epoch_batches_bit_equal(n, batch, drop):
    want = list(jpipe.epoch_batches(np.random.RandomState(3), n, batch, drop))
    got = list(tpipe.epoch_batches(np.random.RandomState(3), n, batch, drop))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_minibatch_stream_bit_equal():
    want = list(itertools.islice(jpipe.minibatch_stream(9, 50, 16), 12))
    got = list(itertools.islice(tpipe.minibatch_stream(9, 50, 16), 12))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _probe_loss_pair():
    def jloss(p):
        return jnp.sum(jnp.sin(p["a"]) * p["c"][0]) + jnp.sum(p["b"] ** 2)

    def tloss(p):
        return (torch.sin(p["a"]) * p["c"][0]).sum() + p["b"].square().sum()

    rs = np.random.RandomState(2)
    params = {"a": rs.randn(6, 4).astype(np.float32),
              "b": rs.randn(5).astype(np.float32),
              "c": [rs.randn(6, 4).astype(np.float32)]}
    return jloss, tloss, params


def test_probe_from_draws_matches_reference():
    """The reference's draws (fold_in(rng, i) split into a direction key,
    folded per leaf, and a distance key), fed to the port as numpy."""
    jloss, tloss, params = _probe_loss_pair()
    rng = jax.random.PRNGKey(7)
    n, radius, bins = 60, 3.0, 6
    want = jprobe(jloss, jax.tree.map(jnp.asarray, params), rng,
                  n_samples=n, max_radius=radius, n_bins=bins)
    leaves = jax.tree.leaves(params)
    dirs, zs = [], []
    for i in range(n):
        rd, rz = jax.random.split(jax.random.fold_in(rng, i))
        dirs.append([np.asarray(jax.random.normal(jax.random.fold_in(rd, j),
                                                  l.shape))
                     for j, l in enumerate(leaves)])
        zs.append(float(jax.random.uniform(rz, (), minval=0.0,
                                           maxval=radius)))
    got = _probe_from_draws(tloss, tree.map(torch.tensor, params),
                            zip(dirs, zs), max_radius=radius, n_bins=bins)
    assert len(want["distance"]) >= 3
    np.testing.assert_allclose(got["distance"], want["distance"], rtol=0,
                               atol=0)
    np.testing.assert_allclose(got["loss_std"], want["loss_std"], rtol=1e-5,
                               atol=1e-5)


def test_random_potential_probe_is_seeded():
    _, tloss, params = _probe_loss_pair()
    tp = tree.map(torch.tensor, params)
    runs = [random_potential_probe(tloss, tp,
                                   torch.Generator().manual_seed(3),
                                   n_samples=40, max_radius=2.0, n_bins=4)
            for _ in range(2)]
    for k in ("distance", "loss_std"):
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
    assert np.all(np.isfinite(runs[0]["loss_std"]))
    assert len(runs[0]["distance"]) >= 3


def _draws_first(params, seed, n, radius):
    """Today's order of the probe's draws, all taken before any loss: per
    sample one ``randn`` a leaf in ``tree.leaves`` order, then z. Returns
    the draws and the generator's state after each sample's draws."""
    g = torch.Generator().manual_seed(seed)
    dirs, zs, states = [], [], []
    for _ in range(n):
        dirs.append([torch.randn(l.shape, generator=g)
                     for l in tree.leaves(params)])
        zs.append(float(torch.rand((), generator=g)) * radius)
        states.append(g.get_state())
    return dirs, zs, states


def test_probe_evaluates_each_direction_before_the_next_draw():
    """The i-th loss change is evaluated right after the i-th draw and
    before the (i+1)-th: the generator's state at each call of the loss is
    the state after exactly that many samples' draws."""
    _, tloss, params = _probe_loss_pair()
    tp = tree.map(torch.tensor, params)
    n, radius = 12, 2.0
    g = torch.Generator().manual_seed(5)
    seen = []

    def loss(p):
        seen.append(g.get_state())
        return tloss(p)

    random_potential_probe(loss, tp, g, n_samples=n, max_radius=radius,
                           n_bins=3)
    _, _, states = _draws_first(tp, 5, n, radius)
    want = [torch.Generator().manual_seed(5).get_state()] + states
    assert len(seen) == n + 1
    for i, (a, b) in enumerate(zip(seen, want)):
        assert torch.equal(a, b), f"call {i} saw another generator state"


def test_probe_equals_draws_taken_first():
    """Bit for bit the results of ``_probe_from_draws`` fed the same draws
    taken all before any loss."""
    _, tloss, params = _probe_loss_pair()
    tp = tree.map(torch.tensor, params)
    n, radius, bins = 40, 2.0, 4
    got = random_potential_probe(tloss, tp, torch.Generator().manual_seed(3),
                                 n_samples=n, max_radius=radius, n_bins=bins)
    dirs, zs, _ = _draws_first(tp, 3, n, radius)
    want = _probe_from_draws(tloss, tp, zip(dirs, zs), max_radius=radius,
                             n_bins=bins)
    assert len(want["distance"]) >= 3
    for k in ("distance", "loss_std"):
        np.testing.assert_array_equal(got[k], want[k])
