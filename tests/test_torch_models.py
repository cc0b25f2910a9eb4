"""The port's vision models (F1 MLP, C1 convnet, ResNet) held to the JAX
package on transplanted parameters: logits and running BN state, f32, 1e-4.
Reduced depth and width, 8x8 inputs, so the stride-2 SAME padding (0, 1) of
an even input is exercised."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.paper_models import (C1_CIFAR10, F1_MNIST,
                                        RESNET44_CIFAR10)
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import paper_models as tpm
from repro_torch.models import cnn as tcnn

TOL = 1e-4

MODELS = {
    "f1": dataclasses.replace(F1_MNIST, input_shape=(8, 8, 1),
                              hidden_sizes=(32, 16), ghost_batch_size=16),
    "c1": dataclasses.replace(C1_CIFAR10, input_shape=(8, 8, 3),
                              channels=(4, 8), ghost_batch_size=16),
    "resnet": dataclasses.replace(RESNET44_CIFAR10, input_shape=(8, 8, 3),
                                  channels=(4, 8, 16), blocks_per_stage=1,
                                  ghost_batch_size=16),
}


def torch_cfg(jcfg):
    """The same configuration as the port's own dataclass."""
    return tpm.VisionModelConfig(**dataclasses.asdict(jcfg))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL)


def _assert_trees_close(t_tree, j_tree):
    got = jax.tree.leaves(convert.to_numpy(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


def jax_model(name, seed=0):
    cfg = MODELS[name]
    init, apply = jcnn.model_fns(cfg)
    params, state = init(jax.random.PRNGKey(seed), cfg)
    return cfg, apply, params, state


def _to_np(t):
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("batch", [40, 32])
def test_logits_and_state_match_reference(name, use_kernels, batch):
    cfg, japply, jp, js = jax_model(name)
    x = np.random.RandomState(batch).randn(batch, *cfg.input_shape) \
        .astype(np.float32)
    japply = jax.jit(japply, static_argnums=2, static_argnames="training")
    jlogits, jns = japply(jp, js, cfg, jnp.asarray(x), training=True)

    tcfg = torch_cfg(cfg)
    _, tapply = tcnn.model_fns(tcfg)
    tp = convert.to_torch(_to_np(jp), device="cpu")
    ts = convert.to_torch(_to_np(js), device="cpu")
    tlogits, tns = tapply(tp, ts, tcfg, torch.tensor(x), training=True,
                          use_kernels=use_kernels)
    _close(tlogits.detach(), jlogits)
    _assert_trees_close(tns, jns)

    # inference with the updated running statistics
    je, _ = japply(jp, jns, cfg, jnp.asarray(x), training=False)
    te, _ = tapply(tp, tns, tcfg, torch.tensor(x), training=False)
    _close(te.detach(), je)


@pytest.mark.parametrize("size,k,stride", [(8, 3, 2), (7, 3, 2), (8, 1, 2),
                                           (8, 3, 1), (5, 3, 2)])
def test_conv_same_padding_matches_xla(size, k, stride):
    rng = np.random.RandomState(size * 10 + k)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 5).astype(np.float32)              # HWIO
    want = jcnn._conv(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = tcnn._conv(torch.tensor(x).permute(0, 3, 1, 2),
                     convert.to_torch(w, device="cpu"), stride)
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("name", list(MODELS))
def test_convert_roundtrip_and_tree_order(name):
    cfg, _, jp, js = jax_model(name, seed=3)
    tp = convert.to_torch(_to_np(jp), device="cpu")
    _assert_trees_close(tp, jp)
    # same structure as the port's own init, leaf for leaf
    own_p, own_s = tcnn.model_fns(torch_cfg(cfg))[0](0, torch_cfg(cfg),
                                                     device="cpu")
    assert [tuple(t.shape) for t in jax.tree.leaves(convert.to_numpy(own_p))] \
        == [tuple(a.shape) for a in jax.tree.leaves(jp)]
    assert jax.tree.structure(convert.to_numpy(own_s)) \
        == jax.tree.structure(_to_np(js))


def test_resnet44_has_43_gbn_layers():
    cfg = torch_cfg(RESNET44_CIFAR10)
    _, state = tcnn.resnet_init(0, cfg, device="cpu")
    n = 1 + sum(len(b) for s in state["stages"] for b in s)
    assert n == 43


def test_init_is_seeded():
    cfg = torch_cfg(MODELS["c1"])
    a, _ = tcnn.init(5, cfg, device="cpu")
    b, _ = tcnn.init(5, cfg, device="cpu")
    c, _ = tcnn.init(6, cfg, device="cpu")
    assert torch.equal(a["stages"][0]["w"], b["stages"][0]["w"])
    assert not torch.equal(a["stages"][0]["w"], c["stages"][0]["w"])
