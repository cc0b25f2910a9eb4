"""Rank bodies of tests/test_torch_sharded_serving.py: run in spawned
processes on the CPU over gloo. They import torch and the port only (never
jax), read their inputs from a pickle the test wrote (numpy, the
reference's layout) and write what the test compares to
``out/rank<r>.pkl``."""
import dataclasses
import os
import pickle

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_2d_mesh
from repro_torch.serving import ContinuousEngine, Request
from repro_torch.serving import engine as E

ENGINE = dict(num_slots=2, max_len=16, page_size=8, layout="paged")
SAMPLING = dict(temperature=0.8, top_k=8)
SAMPLE_SEED = 5


def serving_cfg():
    return dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype="float32")


def requests(trace):
    return [Request(id=i, prompt=np.asarray(p, np.int32), max_new_tokens=n,
                    arrival=a) for i, p, n, a in trace]


def run_engine(params, cfg, trace, **kw):
    """Completions' tokens, the admissions' prefill logits in admission
    order ((request id, logits)) and the engine."""
    seen = []
    admit = E.prefill_fused

    def recording(*args, **kwargs):
        last, cache = admit(*args, **kwargs)
        seen.append(last[0].detach().numpy().copy())
        return last, cache

    eng = ContinuousEngine(params, cfg, **ENGINE, **kw)
    order = []
    base_admit = eng._admit

    def counted(req, slot):
        ok = base_admit(req, slot)
        if ok:
            order.append(req.id)
        return ok

    eng._admit = counted
    E.prefill_fused = recording
    try:
        comps = eng.run(requests(trace))
    finally:
        E.prefill_fused = admit
    toks = {i: [int(t) for t in c.tokens] for i, c in comps.items()}
    return toks, list(zip(order, seen)), eng


def serve(rank, inp_path, out):
    """One rank of a (data, model) mesh: the sharded engine on a float32
    and an int8 pool (greedy) and one sampled run."""
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    torch.set_num_threads(1)
    cfg = serving_cfg()
    params = convert.lm_to_torch(inp["params"], cfg, "cpu")
    mesh = make_2d_mesh(model=2, device="cpu")
    res = {"coords": dict(mesh.coords), "tokens": {}, "logits": {}}
    for cache_dtype in (None, "int8"):
        toks, logits, eng = run_engine(params, cfg, inp["trace"], mesh=mesh,
                                       cache_dtype=cache_dtype)
        label = cache_dtype or "f32"
        res["tokens"][label] = toks
        res["logits"][label] = logits
        if cache_dtype is None:
            attn = eng.cache["body"][0][0]["attn"]
            res["pool"] = tuple(attn["kp"].shape)
            res["pt"] = tuple(attn["pt"].shape)
            res["rows"] = eng._rows
            res["wq"] = tuple(eng.params["stack"]["body"][0][0]["mixer"]
                              ["wq"].shape)
        else:
            res["scales"] = tuple(eng.cache["body"][0][0]["attn"]["ks"]
                                  .shape)
    gen = torch.Generator().manual_seed(SAMPLE_SEED)
    res["sampled"], _, _ = run_engine(params, cfg, inp["trace"], mesh=mesh,
                                      generator=gen, **SAMPLING)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
