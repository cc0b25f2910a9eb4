"""The port's vision train step held to the JAX package's
``make_vision_train_step(use_kernels=True)`` (Pallas GBN pair in interpret
mode) on transplanted parameters and the same batches: loss to 1e-5,
params, momentum and BN state to 1e-4, after one step and after three."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.paper_models import F1_MNIST, RESNET44_CIFAR10
from repro.core.large_batch import presets as jpresets
from repro.core.regime import Regime as JRegime
from repro.data.synthetic import teacher_classification
from repro.models import cnn as jcnn
from repro.optim import sgd as jsgd
from repro.train import trainer as jtrain
from repro_torch import convert
from repro_torch.configs import paper_models as tpm
from repro_torch.core.large_batch import presets as tpresets
from repro_torch.core.regime import Regime as TRegime
from repro_torch.models import cnn as tcnn
from repro_torch.optim import sgd as tsgd
from repro_torch.train import trainer as ttrain

LOSS_TOL, TOL = 1e-5, 1e-4
B, SMALL, GHOST = 48, 16, 16       # 48 = 3 ghosts of 16

MODELS = {
    "f1": dataclasses.replace(F1_MNIST, input_shape=(8, 8, 3),
                              hidden_sizes=(32, 16), ghost_batch_size=GHOST),
    "resnet": dataclasses.replace(RESNET44_CIFAR10, input_shape=(8, 8, 3),
                                  channels=(4, 8), blocks_per_stage=1,
                                  ghost_batch_size=GHOST),
}


@pytest.fixture(scope="module")
def data():
    return teacher_classification(0, n_train=4 * B, n_test=64,
                                  input_shape=(8, 8, 3))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _close(t_tree, j_tree, tol):
    got = jax.tree.leaves(convert.to_numpy(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(data, name, n_steps):
    cfg = MODELS[name]
    tcfg = tpm.VisionModelConfig(**dataclasses.asdict(cfg))
    small = dict(base_lr=0.1, total_steps=10, drop_every=2)
    jlb = jpresets(B, SMALL, GHOST)["LB+LR+GBN+RA"]
    tlb = tpresets(B, SMALL, GHOST)["LB+LR+GBN+RA"]
    jinit, japply = jcnn.model_fns(cfg)
    jp, js = jinit(jax.random.PRNGKey(1), cfg)
    jo = jsgd.init(jp)
    jstep = jax.jit(jtrain.make_vision_train_step(
        japply, cfg, jlb, jlb.build_regime(JRegime(**small)),
        use_kernels=True))
    tstep = ttrain.make_vision_train_step(
        tcnn.model_fns(tcfg)[1], tcfg, tlb,
        tlb.build_regime(TRegime(**small)), use_kernels=True)
    tp = convert.to_torch(_np(jp), device="cpu")
    ts = convert.to_torch(_np(js), device="cpu")
    to = tsgd.init(tp)

    perm = np.random.RandomState(2).permutation(data.n_train)
    for step in range(n_steps):
        idx = perm[step * B:(step + 1) * B]          # the reference's order
        x, y = data.x_train[idx], data.y_train[idx]
        jp, js, jo, jm = jstep(jp, js, jo, jnp.asarray(x), jnp.asarray(y),
                               jnp.int32(step), jax.random.PRNGKey(step))
        tp, ts, to, tm = tstep(tp, ts, to, torch.tensor(x), torch.tensor(y),
                               step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert float(tm["acc"]) == pytest.approx(float(jm["acc"]))
    _close(tp, jp, TOL)
    _close(to.momentum, jo.momentum, TOL)
    _close(ts, js, TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_vision_runs_on_cpu(data, use_kernels):
    tcfg = tpm.VisionModelConfig(**dataclasses.asdict(MODELS["resnet"]))
    lb = tpresets(B, SMALL, GHOST)["LB+LR+GBN+RA"]
    regime = lb.build_regime(TRegime(base_lr=0.1, total_steps=5,
                                     drop_every=3))
    out = ttrain.train_vision(tcnn.model_fns(tcfg), tcfg, data, lb, regime,
                              eval_every=2, use_kernels=use_kernels,
                              device="cpu")
    assert out["steps"] == 5
    h = out["history"]
    assert h["steps"] == [0, 2, 4] and np.isfinite(h["train_loss"]).all()
    assert len(h["distance"]) == 5 and h["distance"][-1] > 0
    assert 0.0 <= out["final_acc"] <= 1.0
    assert {"slope", "r2"} <= set(out["log_fit"])


def test_train_vision_is_seeded(data):
    tcfg = tpm.VisionModelConfig(**dataclasses.asdict(MODELS["f1"]))
    lb = dataclasses.replace(tpresets(B, SMALL, GHOST)["LB+LR+GBN+RA"],
                             ghost_noise=0.5)
    regime = TRegime(base_lr=0.1, total_steps=6, drop_every=3)
    runs = [ttrain.train_vision(tcnn.model_fns(tcfg), tcfg, data, lb, regime,
                                seed=s, eval_every=1, device="cpu")
            for s in (3, 3, 4)]
    assert runs[0]["history"]["train_loss"] == runs[1]["history"]["train_loss"]
    assert runs[0]["history"]["train_loss"] != runs[2]["history"]["train_loss"]
