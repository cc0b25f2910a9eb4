"""The port's parallel layer on the CPU, ranks as processes over gloo,
held to the JAX package's SINGLE-device functions (its own multi-device
tests need device meshes that JAX 0.9 on one CPU does not give).

One spawn of two ranks (module fixture ``world2``) and one of four
(``world4``) run every rank body of ``tests/_torch_parallel_workers.py``;
the tests compare what the ranks wrote:

- data-parallel vision over 2 ranks (reduced ResNet44, LB+LR+GBN+RA, 3
  noise-free steps) against ``repro.train.trainer.make_vision_train_step``
  on the global batch: loss 1e-5, gradients and parameters 1e-4; the
  ranks' parameters bit-identical; one all-reduce a step; the running
  statistics equal to the mean of the reference's per-shard states;
- ``dp_gbn_forward``'s per-rank statistics against
  ``repro.kernels.ref.gbn_ref`` on each shard, stacked rank-major;
- the LM modes over 4 ranks (dp on (4,), tp, fsdp, tp+fsdp and Adam+fsdp
  on (2 data, 2 model); reduced qwen3-1.7b) and expert parallelism
  (reduced qwen2-moe-a2.7b), 3 steps each, against
  ``repro.train.trainer.make_lm_train_step`` with no mesh: losses 1e-5,
  parameters 1e-4; ``seq_parallel`` bit-equal to without it; the
  model-replicated leaves bit-identical across each model group;
- the tp+fsdp run's sharded checkpoint (4 shard files) read by the port's
  ``restore`` and the reference's;
- ``train_lm(mesh=)`` against the single-process ``train_lm``;
- ``_mesh_for``'s ladder and its warnings; a ``use_mesh`` sweep over 2
  ranks against the single-process sweep.
"""
import dataclasses
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_workers as W
from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.checkpoint import checkpoint as jckpt
from repro.configs.paper_models import RESNET44_CIFAR10
from repro.configs.registry import get_config as jget_config
from repro.core import LargeBatchConfig as JLargeBatchConfig
from repro.core import Regime as JRegime
from repro.core.large_batch import presets as jpresets
from repro.data.synthetic import teacher_classification
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.train import trainer as jtrain
from repro_torch import convert, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.experiments import registry as tregistry
from repro_torch.experiments import runner as trunner
from repro_torch.launch.spawn import run_ranks
from repro_torch.optim import adam, sgd
from repro_torch.train import parallel as PAR
from repro_torch.train.trainer import train_lm

CPU = "cpu"
LOSS_TOL, TOL = 1e-5, 1e-4
B, SMALL, GHOST = 64, 16, 16          # 2 ranks x 2 ghosts of 16
REGIME = dict(base_lr=0.1, total_steps=10, drop_every=2)
VISION = dataclasses.replace(RESNET44_CIFAR10, input_shape=(8, 8, 3),
                             channels=(4, 8), blocks_per_stage=1,
                             ghost_batch_size=GHOST)
VOCAB, LM_B, LM_T = 128, 8, 16
ARCHS = {"dense": "qwen3-1.7b", "moe": "qwen2-moe-a2.7b"}
SWEEP = dict(steps=2, large_batch=64, small_batch=32, ghost=16)
SPAWN_TIMEOUT = 300
ACC_TOL = 0.02      # accuracies read through the running statistics


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _trees_close(got, want, tol):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        _close(a, b, tol)


def _spawn(fn, world, inp, tmp):
    path = tmp / "inp.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    run_ranks(fn, world, (str(path), str(tmp)), timeout=SPAWN_TIMEOUT,
              threads=2)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# world of 2: data-parallel vision
# ---------------------------------------------------------------------------


def _vision_reference(batches):
    """The reference's single-device step on the global batches, its step-0
    gradients and its per-shard running statistics."""
    jlb = jpresets(B, SMALL, GHOST)["LB+LR+GBN+RA"]
    jinit, japply = jcnn.model_fns(VISION)
    jp, js = jinit(jax.random.PRNGKey(1), VISION)
    loss_fn = jtrain.make_vision_loss_fn(japply, VISION, jlb)
    x0, y0 = (jnp.asarray(a) for a in batches[0])
    _, jg = jax.value_and_grad(loss_fn, has_aux=True)(jp, js, x0, y0)
    shard_states = [loss_fn(jp, js, x0[i * B // 2:(i + 1) * B // 2],
                            y0[i * B // 2:(i + 1) * B // 2])[1][0]
                    for i in range(2)]
    state0 = jax.tree.map(lambda a, b: a if a.dtype == jnp.bool_
                          else (a + b) / 2, *shard_states)
    step = jax.jit(jtrain.make_vision_train_step(
        japply, VISION, jlb, jlb.build_regime(JRegime(**REGIME))))
    p, s, o = jp, js, jsgd.init(jp)
    losses, params = [], []
    for i, (x, y) in enumerate(batches):
        p, s, o, m = step(p, s, o, jnp.asarray(x), jnp.asarray(y),
                          jnp.int32(i), jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        params.append(jax.device_get(p))
    return {"params0": jax.device_get(jp), "state": jax.device_get(js),
            "grads0": jax.device_get(jg), "state0": jax.device_get(state0),
            "losses": losses, "params": params}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    data = teacher_classification(0, n_train=3 * B, n_test=16,
                                  input_shape=(8, 8, 3))
    batches = [(data.x_train[i * B:(i + 1) * B],
                data.y_train[i * B:(i + 1) * B]) for i in range(3)]
    ref = _vision_reference(batches)
    rs = np.random.RandomState(4)
    inp = {"vision_cfg": dataclasses.asdict(VISION),
           "presets": (B, SMALL, GHOST), "regime": REGIME,
           "params": ref["params0"], "bn_state": ref["state"],
           "batches": batches,
           "gbn_x": rs.randn(48, 3, 5).astype(np.float32),
           "gbn_gamma": rs.randn(5).astype(np.float32),
           "gbn_beta": rs.randn(5).astype(np.float32), "gbn_ghost": 8,
           "sweep": SWEEP, "sweep_dir": str(tmp / "sweep")}
    return inp, ref, _spawn(W.world2, 2, inp, tmp)


def test_dp_vision_matches_reference(world2):
    _, ref, ranks = world2
    _close(ranks[0]["losses"], ref["losses"], LOSS_TOL)
    for got, want in zip(ranks[0]["params"], ref["params"]):
        _trees_close(got, want, TOL)


def test_dp_vision_grads_match_reference(world2):
    _, ref, ranks = world2
    _trees_close(ranks[0]["grads0"], ref["grads0"], TOL)


def test_dp_vision_ranks_stay_bit_identical(world2):
    _, _, ranks = world2
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_dp_vision_running_stats_are_the_mean_of_shard_states(world2):
    """Each rank folds its own ghosts into the EMA, then the ranks average:
    the mean of the reference's per-shard states, not its global-batch
    state."""
    _, ref, ranks = world2
    for r in ranks:
        _trees_close(r["state0"], ref["state0"], LOSS_TOL)


def test_dp_vision_one_all_reduce_a_step(world2):
    """Gradients, the EMA and the two metrics cross in one buffer."""
    _, _, ranks = world2
    assert [r["calls_a_step"] for r in ranks] == [1, 1]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_dp_gbn_forward_stats_are_per_rank(world2, use_kernels):
    inp, _, ranks = world2
    x, g, b = (jnp.asarray(inp[k]) for k in ("gbn_x", "gbn_gamma",
                                              "gbn_beta"))
    half, C_ = x.shape[0] // 2, x.shape[-1]
    want = [jref.gbn_ref(x[i * half:(i + 1) * half].reshape(
        half // inp["gbn_ghost"], -1, C_), g, b) for i in range(2)]
    for rank, r in enumerate(ranks):
        y, mu, var = r["gbn"][use_kernels]
        _close(y, np.asarray(want[rank][0]).reshape(y.shape), TOL)
        _close(mu, np.concatenate([w[1] for w in want]), TOL)
        _close(var, np.concatenate([w[2] for w in want]), TOL)
        assert mu.shape == (2 * half // inp["gbn_ghost"], C_)


def test_use_mesh_sweep_equals_single_process(world2, tmp_path):
    """The +GBN columns, whose ranks each hold whole ghosts, follow the
    single-process sweep's parameter trajectory (the distance series) to
    1e-4. Their accuracies are measured with the running statistics, whose
    EMA differs by design (each rank folds its own ghosts before the
    average), so they are held to ACC_TOL. Without ghosts, BN normalizes
    over each rank's shard (the paper's observation, made literal): those
    columns differ by design and are held to their steps and finite
    values."""
    inp, _, ranks = world2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solo = trunner.run_sweep(tregistry.generalization_gap(**SWEEP),
                                 str(tmp_path), device=CPU)
    by_method = {r["method"]: r for r in solo}
    n_ghost = 0
    for rank in ranks:
        recs = rank["sweep"]
        assert sorted(r["method"] for r in recs) == sorted(by_method)
        for r in recs:
            want = by_method[r["method"]]
            assert r["steps"] == want["steps"]
            assert set(r["metrics"]) == set(want["metrics"])
            if not r["spec"]["lb"]["use_gbn"]:
                assert all(np.isfinite(r[k]) for k in ("final_acc",
                                                        "train_acc"))
                continue
            n_ghost += 1
            for k in ("final_acc", "best_acc", "train_acc"):
                assert abs(r[k] - want[k]) <= ACC_TOL, (r["method"], k)
            for name, (steps, values) in want["metrics"].items():
                assert r["metrics"][name][0] == steps
                _close(r["metrics"][name][1], values, TOL)
    assert n_ghost == 2 * 2
    assert [r["run_id"] for r in ranks[0]["sweep"]] == \
        [r["run_id"] for r in ranks[1]["sweep"]]
    # 2 ranks x whole ghosts hold every method's batch: no degrading
    assert not [w for w in ranks[0]["sweep_warnings"] if "degrading" in w]


# ---------------------------------------------------------------------------
# world of 4: the LM modes
# ---------------------------------------------------------------------------


def _lm_reference(key, optimizer, tokens):
    jcfg = dataclasses.replace(jget_config(ARCHS[key]).reduced(),
                               dtype="float32", vocab_size=VOCAB)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jlb = JLargeBatchConfig(batch_size=LM_B, base_batch_size=LM_B,
                            grad_clip=1.0)
    step = jax.jit(jtrain.make_lm_train_step(
        jcfg, jlb, JRegime(base_lr=W.LM_LR[optimizer], total_steps=10,
                           drop_every=10),
        optimizer=optimizer))
    p = jp
    o = (jadam.init if optimizer == "adam" else jsgd.init)(jp)
    losses = []
    for i, t in enumerate(tokens):
        p, o, m = step(p, o, {"tokens": jnp.asarray(t)}, jnp.int32(i),
                       jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return jax.device_get(jp), {"losses": losses, "params": jax.device_get(p),
                                "opt": jax.device_get(o)}


def _ladder_specs():
    vision = tregistry.generalization_gap(**SWEEP).expand()[0]
    lm = {k: tregistry.lm_smoke(arch=a, steps=2).expand()[0]
          for k, a in ARCHS.items()}
    lb32 = dataclasses.replace(vision.lb, batch_size=32, base_batch_size=32,
                               ghost_batch_size=16, use_gbn=True)
    lb64 = dataclasses.replace(lb32, batch_size=64, base_batch_size=64)
    return {"vision_data": dataclasses.replace(vision, lb=lb64,
                                               use_mesh=True),
            "vision_2d": dataclasses.replace(vision, lb=lb64, use_mesh="2d"),
            "vision_odd": dataclasses.replace(vision, lb=lb32,
                                              use_mesh=True),
            "moe_2d": dataclasses.replace(lm["moe"], use_mesh="2d"),
            "dense_2d": dataclasses.replace(lm["dense"], use_mesh="2d")}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    rs = np.random.RandomState(5)
    tokens = {k: [rs.randint(0, VOCAB, (LM_B, LM_T)).astype(np.int32)
                  for _ in range(W.LM_STEPS)] for k in ARCHS}
    refs, params = {}, {}
    for name, (key, _, _, _, opt, _) in W.LM_MODES.items():
        if (key, opt) not in refs:
            params[key], refs[(key, opt)] = _lm_reference(key, opt,
                                                          tokens[key])
    inp = {"archs": ARCHS, "vocab": VOCAB, "lm_batch": LM_B,
           "lm_params": params, "lm_tokens": tokens,
           "ckpt_dir": str(tmp / "ckpt"),
           "train_ckpt_dir": str(tmp / "train_ckpt"),
           "train_rows": rs.randint(0, VOCAB, (3 * LM_B, LM_T)).astype(
               np.int32),
           "ep_x": rs.randn(2, 12, 256).astype(np.float32),
           "ladder_specs": _ladder_specs()}
    return inp, refs, _spawn(W.world4, 4, inp, tmp)


@pytest.mark.parametrize("mode", ["dp", "tp", "fsdp", "tp_fsdp",
                                  "adam_fsdp", "ep"])
def test_lm_mode_matches_reference(world4, mode):
    _, refs, ranks = world4
    key, _, _, _, optimizer, _ = W.LM_MODES[mode]
    want = refs[(key, optimizer)]
    for r in ranks:
        got = r["lm"][mode]
        _close(got["losses"], want["losses"], LOSS_TOL)
        _trees_close(got["params"], want["params"], TOL)
        _close(np.concatenate([a.ravel() for a in got["opt"]]),
               np.concatenate([np.asarray(a, np.float32).ravel()
                               for a in jax.tree.leaves(want["opt"])]), TOL)


def test_seq_parallel_changes_nothing(world4):
    """The reference's sequence-parallel flag is a layout hint: the same
    bits with and without it."""
    _, _, ranks = world4
    for r in ranks:
        a, b = r["lm"]["tp"], r["lm"]["tp_seq_parallel"]
        assert a["losses"] == b["losses"]
        for x, y in zip(a["local"], b["local"]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["tp", "tp_fsdp", "ep"])
def test_model_replicated_leaves_bit_identical(world4, mode):
    """On (2 data, 2 model) ranks 0, 1 and ranks 2, 3 are model groups:
    every leaf the step does not shard over "model" is the same bits on
    both ranks of a group."""
    inp, _, ranks = world4
    key, _, tp, fsdp, _, _ = W.LM_MODES[mode]
    cfg = W.lm_cfg(ARCHS[key], VOCAB)
    whole = convert.lm_to_torch(inp["lm_params"][key], cfg, CPU)
    stub = type("Mesh", (), {"shape": {"data": 2, "model": 2},
                             "axis_names": ("data", "model")})()
    specs = tree.leaves(PAR.mesh_param_specs(whole, stub, cfg=cfg, tp=tp,
                                             fsdp=fsdp))
    replicated = [i for i, s in enumerate(specs) if "model" not in tuple(s)]
    sharded = [i for i, s in enumerate(specs) if "model" in tuple(s)]
    assert replicated and sharded
    for a, b in ((0, 1), (2, 3)):
        la, lb = ranks[a]["lm"][mode]["local"], ranks[b]["lm"][mode]["local"]
        for i in replicated:
            np.testing.assert_array_equal(la[i], lb[i])
        assert any(not np.array_equal(la[i], lb[i]) for i in sharded)
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]


def test_sharded_checkpoint_read_by_both_restores(world4):
    """Four ranks wrote their tp+fsdp slices (params_3.shard{0..3}.npz);
    the port's restore and the reference's give the whole trees."""
    inp, refs, ranks = world4
    path = inp["ckpt_dir"]
    meta = ckpt.load_meta(path)
    assert meta["sharded"] and meta["num_processes"] == 4 and meta["k"] == 1
    want = ranks[0]["lm"]["tp_fsdp"]
    cfg = W.lm_cfg(ARCHS["dense"], VOCAB)
    template = convert.lm_to_torch(inp["lm_params"]["dense"], cfg, CPU)
    got, step = ckpt.restore(path, template)
    assert step == W.LM_STEPS
    _trees_close(convert.lm_to_numpy(got), want["params"], 0.0)
    opt, _ = ckpt.restore(path, sgd.init(template), kind="opt")
    for a, b in zip(tree.leaves(ckpt._to_reference(opt)), want["opt"]):
        np.testing.assert_array_equal(a, b)
    jtemplate = inp["lm_params"]["dense"]
    jgot, _ = jckpt.restore(path, jtemplate)
    _trees_close(jax.tree.leaves(jax.device_get(jgot)), want["params"], 0.0)
    jopt, _ = jckpt.restore(path, jsgd.init(jtemplate), kind="opt")
    _trees_close(jax.tree.leaves(jax.device_get(jopt)), want["opt"], 0.0)


def test_ep_dispatch_combine_is_the_local_combine(world4):
    _, _, ranks = world4
    assert max(r["ep_dispatch_err"] for r in ranks) < 1e-5


def test_train_lm_over_a_mesh_matches_one_process(world4):
    """train_lm(mesh=) (experts over "model", sharded checkpoints, the
    distance tracked through the sharded norm) against the same run in one
    process."""
    inp, _, ranks = world4
    cfg = W.lm_cfg(ARCHS["moe"], VOCAB)
    lb, regime = W.lm_recipe(LM_B)
    regime = dataclasses.replace(regime, total_steps=W.LM_STEPS)
    solo = train_lm(cfg, lb, regime, inp["train_rows"], seed=0,
                    params=convert.lm_to_torch(inp["lm_params"]["moe"], cfg,
                                               CPU),
                    eval_every=1, holdout=LM_B, track_diffusion=True,
                    diffusion_every=1, device=CPU)
    for r in ranks:
        got = r["train_lm"]
        _close(got["final_ce"], solo["final_ce"], TOL)
        assert set(got["history"]) == set(solo["history"])
        for k, v in solo["history"].items():
            _close(got["history"][k], v, TOL)
    meta = ckpt.load_meta(inp["train_ckpt_dir"])
    assert meta["step"] == 2 and meta["num_processes"] == 4


def test_mesh_for_ladder_and_warnings(world4):
    _, _, ranks = world4
    want = {"vision_data": {"data": 4}, "vision_2d": {"data": 4},
            "vision_odd": None, "moe_2d": {"data": 2, "model": 2},
            "dense_2d": {"data": 4}}
    for r in ranks:
        assert r["ladder"] == want
        degrading = sorted(w.split(";")[1].strip() for w in
                           r["ladder_warnings"] if "degrading" in w)
        assert degrading == ["degrading to 'data'",
                             "degrading to 'single-device'"]
    # one process: every request runs on one device, with one warning
    trunner._DEGRADE_WARNED.clear()
    try:
        with pytest.warns(RuntimeWarning, match="'2d'.*'single-device'"):
            assert trunner._mesh_for(_ladder_specs()["moe_2d"], CPU) is None
    finally:
        trunner._DEGRADE_WARNED.clear()
