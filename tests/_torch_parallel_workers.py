"""Rank bodies of tests/test_torch_parallel.py: run in spawned processes
on the CPU over gloo. They import torch and the port only (never jax), read
their inputs from a pickle the test wrote (numpy, the reference's layout)
and write what the test compares to ``out/rank<r>.pkl``."""
import dataclasses
import os
import pickle
import warnings

import numpy as np
import torch

from repro_torch import convert, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs import paper_models as tpm
from repro_torch.core import LargeBatchConfig, Regime
from repro_torch.core import expert_parallel as EP
from repro_torch.core.large_batch import presets
from repro_torch.data.pipeline import shard_batch
from repro_torch.experiments import registry, runner
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (DATA_AXIS, MODEL_AXIS, make_2d_mesh,
                                     make_data_mesh)
from repro_torch.models import cnn, moe
from repro_torch.optim import adam, sgd
from repro_torch.train import data_parallel as DP
from repro_torch.train import parallel as PAR
from repro_torch.train.trainer import make_lm_train_step, train_lm

CPU = "cpu"
LM_STEPS = 3


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(out, rank, res):
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _np(t):
    return [a.detach().float().numpy() for a in tree.leaves(t)]


def lm_cfg(arch, vocab):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               vocab_size=vocab)


LM_LR = {"sgd": 0.05, "adam": 1e-3}


def lm_recipe(batch, optimizer="sgd"):
    lb = LargeBatchConfig(batch_size=batch, base_batch_size=batch,
                          grad_clip=1.0)
    return lb, Regime(base_lr=LM_LR[optimizer], total_steps=10,
                      drop_every=10)


# ---------------------------------------------------------------------------
# world 2: data-parallel vision, dp_gbn_forward, a use_mesh sweep
# ---------------------------------------------------------------------------


def world2(rank, inp_path, out):
    inp = _load(inp_path)
    res = {}
    mesh = make_data_mesh(device=CPU)
    cfg = tpm.VisionModelConfig(**inp["vision_cfg"])
    lb = presets(*inp["presets"])["LB+LR+GBN+RA"]
    regime = lb.build_regime(Regime(**inp["regime"]))
    apply_fn = cnn.model_fns(cfg)[1]
    p = convert.to_torch(inp["params"], device=CPU)
    s = convert.to_torch(inp["bn_state"], device=CPU)
    o = sgd.init(p)
    grads_fn = PAR.make_mesh_vision_grads(apply_fn, cfg, lb, mesh,
                                          use_kernels=True)
    step = DP.make_dp_vision_train_step(apply_fn, cfg, lb, regime, mesh,
                                        use_kernels=True)
    res["losses"], res["params"], res["states"] = [], [], []
    for i, (x, y) in enumerate(inp["batches"]):
        xy = shard_batch({"x": torch.tensor(x), "y": torch.tensor(y)}, mesh)
        if i == 0:
            _, _, st0, g0 = grads_fn(p, s, xy["x"], xy["y"])
            res["grads0"] = convert.to_numpy(g0)
            res["state0"] = convert.to_numpy(st0)
        C.reset_stats()
        p, s, o, m = step(p, s, o, xy["x"], xy["y"], i)
        res["calls_a_step"] = C.STATS["calls"]
        res["losses"].append(float(m["loss"]))
        res["params"].append(convert.to_numpy(p))
    # dp_gbn_forward: this rank's rows, every rank's statistics
    x = torch.tensor(inp["gbn_x"])
    xs = shard_batch({"x": x}, mesh)["x"]
    g, b = torch.tensor(inp["gbn_gamma"]), torch.tensor(inp["gbn_beta"])
    res["gbn"] = {uk: [t.numpy() for t in DP.dp_gbn_forward(
        xs, g, b, mesh, ghost_batch_size=inp["gbn_ghost"], use_kernels=uk)]
        for uk in (False, True)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner._DEGRADE_WARNED.clear()
        sweep = registry.generalization_gap(**inp["sweep"], use_mesh=True)
        res["sweep"] = runner.run_sweep(sweep, inp["sweep_dir"],
                                        device=CPU)
    res["sweep_warnings"] = [str(w.message) for w in caught]
    _dump(out, rank, res)


# ---------------------------------------------------------------------------
# world 4: the LM modes, EP, the sharded checkpoint, the ladder
# ---------------------------------------------------------------------------


LM_MODES = {
    # name: (arch key, mesh, tp, fsdp, optimizer, seq_parallel)
    "dp": ("dense", "data", False, False, "sgd", False),
    "tp": ("dense", "2d", True, False, "sgd", False),
    "fsdp": ("dense", "2d", False, True, "sgd", False),
    "tp_fsdp": ("dense", "2d", True, True, "sgd", False),
    "adam_fsdp": ("dense", "2d", False, True, "adam", False),
    "tp_seq_parallel": ("dense", "2d", True, False, "sgd", True),
    "ep": ("moe", "2d", False, False, "sgd", False),
}


def _lm_run(inp, meshes, name):
    key, mkey, tp, fsdp, optimizer, sp = LM_MODES[name]
    mesh = meshes[mkey]
    arch = inp["archs"][key]
    cfg = lm_cfg(arch, inp["vocab"])
    params = convert.lm_to_torch(inp["lm_params"][key], cfg, CPU)
    lb, regime = lm_recipe(inp["lm_batch"], optimizer)
    step = make_lm_train_step(cfg, lb, regime, mesh=mesh, params=params,
                              tp=tp, fsdp=fsdp, optimizer=optimizer,
                              seq_parallel=sp)
    init = adam.init if optimizer == "adam" else sgd.init
    p = PAR.shard_tree(mesh, params, step.param_specs)
    o = PAR.shard_tree(mesh, init(params), step.opt_specs)
    losses = []
    for i, tokens in enumerate(inp["lm_tokens"][key]):
        batch = shard_batch({"tokens": torch.tensor(tokens)}, mesh)
        p, o, m = step(p, o, batch, i)
        losses.append(float(m["loss"]))
    whole = PAR.unshard_tree(mesh, p, step.param_specs)
    opt_whole = PAR.unshard_tree(mesh, o, step.opt_specs)
    out = {"losses": losses, "params": convert.lm_to_numpy(whole),
           "opt": tree.leaves(ckpt._to_reference(opt_whole)),
           "local": _np(p)}
    return out, (mesh, p, o, step)


def _ep_dispatch(inp, mesh):
    """ep_dispatch_combine from whole expert weights against the local
    combine with every expert."""
    cfg = lm_cfg(inp["archs"]["moe"], inp["vocab"])
    params = convert.lm_to_torch(inp["lm_params"]["moe"], cfg, CPU)
    ff = params["stack"]["body"][0][0]["ff"]
    x = torch.tensor(inp["ep_x"])
    m = cfg.moe
    C_ = m.tokens_capacity(x.shape[1])
    topi, topw, _ = moe._route(ff["router"], x, m, losses=False)
    slot, keep = moe._slots(topi, C_)
    got = EP.ep_dispatch_combine(ff, m, x, topi, topw, slot, keep, C_, mesh)
    want = EP.local_combine(x, topi, topw, slot, keep, ff["w_gate"],
                            ff["w_up"], ff["w_down"], C_)
    return float((got - want).abs().max())


def world4(rank, inp_path, out):
    inp = _load(inp_path)
    meshes = {"data": make_data_mesh(device=CPU),
              "2d": make_2d_mesh(device=CPU)}
    res = {"lm": {}}
    for name in LM_MODES:
        res["lm"][name], live = _lm_run(inp, meshes, name)
        if name == "tp_fsdp":
            mesh, p, o, step = live
            ckpt.save(inp["ckpt_dir"], LM_STEPS, p, o, extra={"k": 1},
                      sharded=True,
                      layout=(mesh, step.param_specs, step.opt_specs))
    res["ep_dispatch_err"] = _ep_dispatch(inp, meshes["2d"])
    res["coords"] = meshes["2d"].coords
    # train_lm over the 2-D mesh (experts over "model"), checkpointing and
    # tracking the distance from the initialization
    cfg = lm_cfg(inp["archs"]["moe"], inp["vocab"])
    lb, regime = lm_recipe(inp["lm_batch"])
    regime = dataclasses.replace(regime, total_steps=LM_STEPS)
    run = train_lm(cfg, lb, regime, inp["train_rows"], seed=0,
                   params=convert.lm_to_torch(inp["lm_params"]["moe"], cfg,
                                              CPU),
                   eval_every=1, holdout=inp["lm_batch"],
                   track_diffusion=True, diffusion_every=1,
                   checkpoint_dir=inp["train_ckpt_dir"], checkpoint_every=2,
                   mesh=meshes["2d"], device=CPU)
    res["train_lm"] = {"history": run["history"],
                       "final_ce": run["final_ce"]}
    # the ladder over a world of four
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner._DEGRADE_WARNED.clear()
        got = {}
        for label, spec in inp["ladder_specs"].items():
            mesh = runner._mesh_for(spec, CPU)
            got[label] = None if mesh is None else dict(mesh.shape)
    res["ladder"] = got
    res["ladder_warnings"] = [str(w.message) for w in caught]
    res["axes"] = (DATA_AXIS, MODEL_AXIS)
    _dump(out, rank, res)
