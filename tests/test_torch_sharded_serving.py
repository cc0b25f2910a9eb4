"""Model-sharded serving in the port on the CPU, ranks as processes over
gloo, held to the port's unsharded engine and to the JAX package's
UNSHARDED ``repro.serving.ContinuousEngine`` (its own sharded test,
tests/test_serving_continuous.py:274-332, needs a 4-device mesh that JAX
0.9 on one CPU does not give).

Reduced qwen3-1.7b in f32 on transplanted parameters, the reference test's
trace (5 requests of 4 or 8 tokens, 6 new tokens each, arrivals 0.9
apart), 2 slots, max_len 16, pages of 8. One spawn of two ranks (1 data,
2 model) and one of four (2 data, 2 model) run the rank body of
``tests/_torch_serving_workers.py``:

- every completion's greedy tokens, float32 and int8 pools, equal the
  unsharded port engine's and the reference engine's;
- each admission's prefill logits are within 1e-4 of the unsharded run's;
- a sampled run (temperature 0.8, top-k 8) gives the unsharded engine's
  tokens for the same generator seed;
- each rank's pool holds n_kv_heads / 2 heads, its projections its share
  of the q heads, and on (2, 2) its one row of the block table.

``rules.cache_specs`` equals the reference's on every leaf of paged,
head, seq, ring, int8, SSM and cross caches over the shape-only mesh stubs
of tests/test_torch_parallel_specs.py, and ``rules.cache_slice`` cuts a
whole cache by them. The engine refuses MoE and SSM blocks and head
counts that do not split on a mesh.
"""
import dataclasses
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_serving_workers as W
from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.registry import get_config as jget_config
from repro.models import transformer as JT
from repro.serving import ContinuousEngine as JEngine
from repro.serving import Request as JRequest
from repro.sharding import rules as jrules
from repro_torch import convert
from repro_torch.configs import LayerSpec, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousEngine
from repro_torch.sharding import rules

CPU = "cpu"
TOL = 1e-4
SPAWN_TIMEOUT = 300
N_REQ, NEW = 5, 6


def _trace():
    """tests/test_serving_continuous.py:290-296."""
    r = np.random.RandomState(0)
    cfg = W.serving_cfg()
    out = []
    for i in range(N_REQ):
        L = int(r.choice([4, 8]))
        prompt = r.randint(0, cfg.vocab_size, size=(L,)).astype("int32")
        out.append((i, prompt, NEW, 0.9 * i))
    return out


@pytest.fixture(scope="module")
def unsharded():
    """The reference's parameters, its engine's greedy tokens (plain path)
    for each pool, and the port's unsharded engine: tokens, prefill logits
    and a sampled run."""
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               dtype="float32")
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    trace = _trace()
    jreqs = [JRequest(id=i, prompt=p, max_new_tokens=n, arrival=a)
             for i, p, n, a in trace]
    kw = {k: v for k, v in W.ENGINE.items()}
    ref = {}
    for cd in (None, "int8"):
        comps = JEngine(jp, jcfg, use_kernels=False, cache_dtype=cd,
                        **kw).run(jreqs)
        ref[cd or "f32"] = {i: [int(t) for t in c.tokens]
                            for i, c in comps.items()}
    cfg = W.serving_cfg()
    tp = convert.lm_to_torch(jp, cfg, CPU)
    port = {"tokens": {}, "logits": {}}
    for cd in (None, "int8"):
        toks, logits, _ = W.run_engine(tp, cfg, trace, cache_dtype=cd,
                                       device=CPU)
        port["tokens"][cd or "f32"] = toks
        port["logits"][cd or "f32"] = logits
    gen = torch.Generator().manual_seed(W.SAMPLE_SEED)
    port["sampled"], _, _ = W.run_engine(tp, cfg, trace, generator=gen,
                                         device=CPU, **W.SAMPLING)
    return {"params": jp, "trace": trace, "ref": ref, "port": port}


def _spawn(world, unsharded, tmp):
    path = tmp / "inp.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": unsharded["params"],
                     "trace": unsharded["trace"]}, f)
    run_ranks(W.serve, world, (str(path), str(tmp)), timeout=SPAWN_TIMEOUT,
              threads=1)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(unsharded, tmp_path_factory):
    """{mesh name: every rank's results}, one spawn a mesh."""
    return {name: _spawn(world, unsharded, tmp_path_factory.mktemp(name))
            for name, world in (("1x2", 2), ("2x2", 4))}


MESHES = ("1x2", "2x2")


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_engine_equals_unsharded_and_reference(unsharded, ranks,
                                                       mesh, pool):
    want = unsharded["port"]["tokens"][pool]
    assert want == unsharded["ref"][pool]
    assert sorted(want) == list(range(N_REQ))
    assert all(len(t) == NEW for t in want.values())
    for r in ranks[mesh]:
        assert r["tokens"][pool] == want, r["coords"]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_prefill_logits_match_unsharded(unsharded, ranks, mesh):
    for pool in ("f32", "int8"):
        want = unsharded["port"]["logits"][pool]
        for r in ranks[mesh]:
            got = r["logits"][pool]
            assert [i for i, _ in got] == [i for i, _ in want]
            for (i, g), (_, w) in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                           err_msg=f"request {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_sampling_equals_unsharded(unsharded, ranks, mesh):
    want = unsharded["port"]["sampled"]
    assert want != unsharded["port"]["tokens"]["f32"]   # it does sample
    for r in ranks[mesh]:
        assert r["sampled"] == want, r["coords"]


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_holds_its_share_of_heads_and_rows(ranks, mesh):
    cfg = W.serving_cfg()
    n_pages = 1 + 2 * (16 // 8)
    data = 2 if mesh == "2x2" else 1
    for r in ranks[mesh]:
        assert r["pool"] == (n_pages, cfg.n_kv_heads // 2, 8, cfg.head_dim)
        assert r["scales"] == (n_pages, cfg.n_kv_heads // 2, 8)
        assert r["wq"] == (cfg.d_model, cfg.n_heads // 2 * cfg.head_dim)
        assert r["pt"] == (2 // data, 2)
        first = r["coords"]["data"] * (2 // data)
        assert r["rows"] == (first, first + 2 // data)


# ---------------------------------------------------------------------------
# cache_specs against the reference, on shape-only stubs
# ---------------------------------------------------------------------------


def _stub(**axes):
    return SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))


STUBS = {"2x2": dict(data=2, model=2), "4x1": dict(data=4, model=1),
         "2x2x2": dict(pod=2, data=2, model=2), "1x4": dict(data=1, model=4),
         "1x8": dict(data=1, model=8)}     # (the rules read "model")


def _qwen(**kw):
    j = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                            dtype="float32", **kw)
    t = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                            dtype="float32", **kw)
    return j, t


def _ring():
    j, t = _qwen(body_repeats=1)
    j = dataclasses.replace(j, body_pattern=(
        JLayerSpec(mixer="attn", ff="dense"),
        JLayerSpec(mixer="swa", ff="dense")))
    t = dataclasses.replace(t, body_pattern=(
        LayerSpec(mixer="attn", ff="dense"),
        LayerSpec(mixer="swa", ff="dense")))
    return j, t


def _arch(name):
    return (dataclasses.replace(jget_config(name).reduced(), dtype="float32"),
            dataclasses.replace(get_config(name).reduced(), dtype="float32"))


CACHES = {   # name: (configs, init_cache keywords)
    "paged": (_qwen, dict(layout="paged", page_size=8)),
    "int8": (_qwen, dict(layout="paged", page_size=8, cache_dtype="int8")),
    "head": (_qwen, dict(layout="head")),
    "seq": (_qwen, dict(layout="seq")),
    "ring": (_ring, dict(layout="paged", page_size=8)),
    "ssm": (lambda: _arch("jamba-v0.1-52b"), dict(layout="paged",
                                                  page_size=8)),
    "cross": (lambda: _arch("llama-3.2-vision-11b"),
              dict(layout="head", memory_len=4)),
}


def _ref_by_path(jspecs):
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jrules.path_str(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("stub", list(STUBS))
@pytest.mark.parametrize("cache", list(CACHES))
def test_cache_specs_match_reference(cache, stub, batch):
    """A port leaf's spec is the reference's; a body layer
    (body/<slot>/<layer>/...) the reference's stacked leaf's without its
    leading None. The batch of 3 divides no data axis."""
    cfgs, kw = CACHES[cache]
    jcfg, tcfg = cfgs()
    mesh = _stub(**STUBS[stub])
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, 16, **kw))
    tcache = TT.init_cache(tcfg, batch, 16, device="meta", **kw)
    want = _ref_by_path(jrules.cache_specs(jcache, mesh, batch))
    got = {}
    rules.map_with_path(lambda p, s: got.__setitem__(p, tuple(s)),
                        rules.cache_specs(tcache, mesh, batch))
    seen = set()
    for path, spec in got.items():
        parts = path.split("/")
        if "body" in parts:
            i = parts.index("body")
            ref_path = "/".join(parts[:i + 2] + parts[i + 3:])
            ref = want[ref_path]
            assert ref[0] is None, ref_path
            ref = ref[1:]
        else:
            ref_path, ref = path, want[path]
        assert spec == ref, (path, spec, ref)
        seen.add(ref_path)
    assert seen == set(want)


class _RankStub:
    """The parts of a Mesh that ``cache_slice`` reads, at given
    coordinates."""

    def __init__(self, **coords_sizes):
        self.shape = {a: n for a, (_, n) in coords_sizes.items()}
        self.axis_names = tuple(coords_sizes)
        self.coords = {a: c for a, (c, _) in coords_sizes.items()}
        self.device = torch.device(CPU)

    def axis_size(self, axes):
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, axes):
        return tmesh.Mesh.index(self, axes)


def test_cache_slice_cuts_by_the_specs_and_keeps_the_table_shared():
    _, cfg = _qwen()
    whole = TT.init_cache(cfg, 4, 16, layout="paged", page_size=8,
                          cache_dtype="int8", device=CPU)
    for leaf in (whole["body"][0][0]["attn"]["kp"],
                 whole["body"][0][0]["attn"]["pt"]):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    mesh = _RankStub(data=(1, 2), model=(1, 2))
    specs = rules.cache_specs(whole, mesh, 4)
    local = rules.cache_slice(mesh, whole, specs)
    a0, w0 = local["body"][0][0]["attn"], whole["body"][0][0]["attn"]
    kv = cfg.n_kv_heads // 2
    assert torch.equal(a0["kp"], w0["kp"][:, kv:])
    assert torch.equal(a0["pt"], w0["pt"][2:])
    assert a0["ks"].shape == (w0["ks"].shape[0], kv, 8)
    assert all(c["attn"]["pt"] is a0["pt"]
               for row in local["body"] for c in row)
    meta = TT.init_cache(cfg, 4, 16, layout="paged", page_size=8,
                         device="meta")
    zeros = rules.cache_slice(mesh, meta, rules.cache_specs(meta, mesh, 4))
    z0 = zeros["body"][0][0]["attn"]
    assert z0["kp"].device.type == CPU and not z0["kp"].any()
    assert z0["kp"].shape == a0["kp"].shape and z0["pt"].shape == (2, 2)


@pytest.mark.parametrize("arch,match", [
    ("jamba-v0.1-52b", "MoE and SSM"), ("falcon-mamba-7b", "MoE and SSM"),
    ("qwen2-moe-a2.7b", "MoE and SSM"), ("qwen3-1.7b", "do not split")])
def test_engine_refuses_what_it_does_not_shard(arch, match):
    """MoE and SSM blocks (served under GSPMD by the reference) and head
    counts that do not split over the model axis raise, naming why."""
    cfg = get_config(arch + "-reduced")
    mesh = _RankStub(data=(0, 1), model=(0, 4 if arch == "qwen3-1.7b"
                                         else 2))
    with pytest.raises(NotImplementedError, match=match):
        ContinuousEngine({}, cfg, mesh=mesh, **W.ENGINE)
