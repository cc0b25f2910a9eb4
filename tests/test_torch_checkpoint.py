"""The port's run-state checkpoints held to the JAX package's
(``repro.checkpoint``): the same npz entry names, and vision params,
momentum and BN state (F1 and a reduced ResNet) and reduced-LM params
with SGD and Adam states (qwen3-1.7b, falcon-mamba-7b, the MoE models
qwen2-moe-a2.7b and kimi-k2-1t-a32b, whose stacked experts are (R, E, d,
f) and whose shared expert is a nested tree, the hybrid jamba-v0.1-52b,
and the encoder-decoder seamless-m4t-large-v2, whose ``encoder`` holds a
second stack, here deeper than the decoder's, and whose blocks hold the
``norm_x``/``cross`` leaves) written by either
package restore in the other bit for bit; the port reads the JAX package's
sharded files (one process, and pieces of two processes); the meta and the
``latest`` pointer; a one-process ``sharded=True`` save (the multi-rank
one: tests/test_torch_parallel.py); a missing checkpoint and an unknown
kind raise."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro import checkpoint as jckpt
from repro.configs.paper_models import F1_MNIST, RESNET44_CIFAR10
from repro.configs.registry import get_config as jget_config
from repro.models import cnn as jcnn
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro_torch import checkpoint as ckpt
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.configs import paper_models as tpm
from repro_torch.models import cnn as tcnn
from repro_torch.models import transformer as TT
from repro_torch.optim import adam, sgd

CPU = "cpu"
VISION = {
    "f1": dataclasses.replace(F1_MNIST, input_shape=(8, 8, 1),
                              hidden_sizes=(32, 16), ghost_batch_size=16),
    "resnet": dataclasses.replace(RESNET44_CIFAR10, input_shape=(8, 8, 3),
                                  channels=(4, 8), blocks_per_stage=1,
                                  ghost_batch_size=16),
}
ARCHS = ("qwen3-1.7b", "falcon-mamba-7b", "qwen2-moe-a2.7b",
         "kimi-k2-1t-a32b", "jamba-v0.1-52b", "seamless-m4t-large-v2")


def _np(t):
    return jax.tree.map(np.asarray, t)


def _perturbed(t, seed):
    """Distinct values in every leaf (a fresh init has zero momentum and
    constant BN state, which would hide a mixed-up entry)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.randn(*np.shape(a))).astype(a.dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        t)


def _equal_trees(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, a.dtype, b.shape, b.dtype)
        np.testing.assert_array_equal(a, b)


def _entries(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as d:
                out[name] = {k: (d[k].shape, d[k].dtype.str) for k in d.files}
    return out


def _vision_trees(name):
    """(JAX trees, port trees) of the same values: params, SGD state with
    non-zero momentum and step 7, BN state with live statistics."""
    cfg = VISION[name]
    tcfg = tpm.VisionModelConfig(**dataclasses.asdict(cfg))
    jp, js = jcnn.model_fns(cfg)[0](jax.random.PRNGKey(0), cfg)
    jp, js = _perturbed(_np(jp), 1), _perturbed(_np(js), 2)
    jo = jsgd.SGDState(_perturbed(_np(jsgd.init(jp).momentum), 3),
                       np.int32(7))
    tp, ts = convert.to_torch(jp, CPU), convert.to_torch(js, CPU)
    to = sgd.SGDState(convert.to_torch(jo.momentum, CPU),
                      torch.tensor(7, dtype=torch.int32))
    templates = tcnn.model_fns(tcfg)[0](5, tcfg, CPU)
    return (jp, jo, js), (tp, to, ts), templates


@pytest.mark.parametrize("name", list(VISION))
def test_vision_reference_checkpoint_restores_in_port(tmp_path, name):
    (jp, jo, js), (tp, to, ts), (tmpl_p, tmpl_s) = _vision_trees(name)
    jckpt.save(str(tmp_path), 7, jp, jo, extra={"epoch": 2, "cursor": 96},
               bn_state=js)
    got_p, step = ckpt.restore(str(tmp_path), tmpl_p)
    got_o, _ = ckpt.restore(str(tmp_path), sgd.init(tmpl_p), kind="opt")
    got_s, _ = ckpt.restore(str(tmp_path), tmpl_s, kind="state")
    assert step == 7
    _equal_trees(tree.leaves(got_p), tree.leaves(tp))
    _equal_trees(tree.leaves(got_o.momentum), tree.leaves(to.momentum))
    assert got_o.step.dtype == torch.int32 and int(got_o.step) == 7
    _equal_trees(tree.leaves(got_s), tree.leaves(ts))
    assert all(a.dtype == b.dtype for a, b in zip(tree.leaves(got_s),
                                                   tree.leaves(tmpl_s)))
    meta = ckpt.load_meta(str(tmp_path))
    assert meta == {"step": 7, "epoch": 2, "cursor": 96}


@pytest.mark.parametrize("name", list(VISION))
def test_vision_port_checkpoint_restores_in_reference(tmp_path, name):
    (jp, jo, js), (tp, to, ts), _ = _vision_trees(name)
    ckpt.save(str(tmp_path / "port"), 7, tp, to, extra={"epoch": 2},
              bn_state=ts)
    jckpt.save(str(tmp_path / "ref"), 7, jp, jo, extra={"epoch": 2},
               bn_state=js)
    assert _entries(tmp_path / "port") == _entries(tmp_path / "ref")
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)   # noqa: E731
    got_p, _ = jckpt.restore(str(tmp_path / "port"), zeros(jp))
    got_o, _ = jckpt.restore(str(tmp_path / "port"),
                             jsgd.SGDState(zeros(jo.momentum),
                                           jnp.int32(0)), kind="opt")
    got_s, _ = jckpt.restore(str(tmp_path / "port"), zeros(js),
                             kind="state")
    _equal_trees(got_p, jp)
    _equal_trees(got_o.momentum, jo.momentum)
    assert int(got_o.step) == 7
    _equal_trees(got_s, js)
    assert jckpt.load_meta(str(tmp_path / "port")) == \
        jckpt.load_meta(str(tmp_path / "ref"))


def _lm_cfgs(arch):
    j = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    t = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if t.encoder is not None:
        # an encoder deeper than the decoder: each stack keeps its own depth
        j, t = (dataclasses.replace(c, encoder=dataclasses.replace(
            c.encoder, n_layers=c.body_repeats + 1)) for c in (j, t))
    return j, t


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_lm_checkpoints_cross_load(tmp_path, arch, opt):
    jcfg, tcfg = _lm_cfgs(arch)
    jp = _perturbed(_np(JT.init_params(jax.random.PRNGKey(0), jcfg)), 1)
    if opt == "sgd":
        jo = jsgd.SGDState(_perturbed(jsgd.init(jp).momentum, 2), np.int32(5))
        to = convert.lm_opt_state_to_torch(jo, tcfg, CPU)
        t_init, j_init = sgd.init, jsgd.init
    else:
        ja = jadam.init(jp)
        jo = jadam.AdamState(_perturbed(ja.mu, 2), _perturbed(ja.nu, 3),
                             np.int32(5))
        to = convert.lm_opt_state_to_torch(jo, tcfg, CPU)
        t_init, j_init = adam.init, jadam.init
    tp = convert.lm_to_torch(jp, tcfg, CPU)
    tmpl = TT.init_params(9, tcfg, CPU)

    # the reference's checkpoint -> the port
    jckpt.save(str(tmp_path / "ref"), 5, jp, jo)
    got_p, _ = ckpt.restore(str(tmp_path / "ref"), tmpl)
    got_o, _ = ckpt.restore(str(tmp_path / "ref"), t_init(tmpl), kind="opt")
    _equal_trees(tree.leaves(got_p), tree.leaves(tp))
    _equal_trees(tree.leaves(got_o), tree.leaves(to))
    assert type(got_o) is type(to)

    # the port's checkpoint -> the reference, entry for entry the same file
    ckpt.save(str(tmp_path / "port"), 5, tp, to)
    assert _entries(tmp_path / "port") == _entries(tmp_path / "ref")
    jtmpl = JT.init_params(jax.random.PRNGKey(9), jcfg)
    got_jp, _ = jckpt.restore(str(tmp_path / "port"), jtmpl)
    got_jo, _ = jckpt.restore(str(tmp_path / "port"), j_init(jtmpl),
                              kind="opt")
    _equal_trees(got_jp, jp)
    _equal_trees(got_jo, jo)


def test_port_reads_reference_sharded_layout(tmp_path):
    """The reference's one-process sharded save, and a leaf split across
    two processes' files (the layout of a 2-process save), reassemble."""
    (jp, jo, js), (tp, to, ts), (tmpl_p, tmpl_s) = _vision_trees("resnet")
    jckpt.save(str(tmp_path), 3, jp, jo, bn_state=js, sharded=True)
    assert (tmp_path / "params_3.shard0.npz").exists()
    assert not (tmp_path / "params_3.npz").exists()
    got_p, step = ckpt.restore(str(tmp_path), tmpl_p)
    got_s, _ = ckpt.restore(str(tmp_path), tmpl_s, kind="state")
    assert step == 3
    _equal_trees(tree.leaves(got_p), tree.leaves(tp))
    _equal_trees(tree.leaves(got_s), tree.leaves(ts))

    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    two = tmp_path / "two"
    os.makedirs(two)
    np.savez(two / "params_1.shard0.npz",
             **{"w##0:2,0:6": w[:2], "s##": np.float32(2.5)})
    np.savez(two / "params_1.shard1.npz", **{"w##2:4,0:6": w[2:]})
    (two / "latest").write_text("1")
    got, _ = ckpt.restore(str(two), {"w": torch.zeros(4, 6),
                                     "s": torch.zeros(())})
    np.testing.assert_array_equal(got["w"].numpy(), w)
    assert float(got["s"]) == 2.5


def test_save_layout_meta_and_errors(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), params)
    with pytest.raises(FileNotFoundError):
        ckpt.load_meta(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) is None
    one = tmp_path / "one_process_sharded"
    ckpt.save(str(one), 5, params, sharded=True)
    assert (one / "params_5.shard0.npz").exists()
    assert ckpt.load_meta(str(one)) == {"step": 5, "sharded": True,
                                        "num_processes": 1}
    got, _ = ckpt.restore(str(one), params)
    assert torch.equal(got["w"], params["w"])
    ckpt.save(str(tmp_path), 1, params, extra={"cursor": 8})
    ckpt.save(str(tmp_path), 2, params, extra={"cursor": 16})
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not (tmp_path / "latest.tmp").exists()
    assert ckpt.load_meta(str(tmp_path), step=1)["cursor"] == 8
    assert json.loads((tmp_path / "meta_2.json").read_text()) == \
        {"step": 2, "cursor": 16}
    got, step = ckpt.restore(str(tmp_path), params, step=1)
    assert step == 1 and torch.equal(got["w"], params["w"])
    with pytest.raises(ValueError, match="kind"):
        ckpt.restore(str(tmp_path), params, kind="momentum")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(3, 2),
                                     "b": torch.ones(3)})
    with pytest.raises(KeyError, match="'c'"):
        ckpt.restore(str(tmp_path), {**params, "c": torch.zeros(())})
