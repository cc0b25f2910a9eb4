"""The port's sharding specs and mesh geometry against the JAX package's,
on the same parameter trees and shape-only mesh stubs (no processes).

- ``rules.param_specs`` and ``parallel.mesh_param_specs`` (dp, tp, fsdp,
  tp+fsdp) on reduced qwen3-1.7b, qwen2-moe-a2.7b, jamba-v0.1-52b and
  seamless-m4t-large-v2 over (data, model), pure-data and (pod, data,
  model) stubs: a port leaf's spec is the reference's (a body layer's
  without the reference's leading stacked None);
- ``mesh_compatible``, ``state_bytes_per_device``, ``batch_spec`` and the
  mesh helpers equal the reference's, error cases included
  (tests/test_parallel_2d.py:400-470 is the model);
- the one-process meshes and ``global_array``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.registry import get_config as jget_config
from repro.core import LargeBatchConfig as JLB
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.sharding import rules as jrules
from repro.train import parallel as jpar
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import LargeBatchConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import adam
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.train import parallel as PAR

CPU = "cpu"
ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
         "seamless-m4t-large-v2")
MESHES = {"2x2": dict(data=2, model=2), "4": dict(data=4),
          "2x2x2": dict(pod=2, data=2, model=2), "1x4": dict(data=1, model=4)}
MODES = {"dp": dict(), "tp": dict(tp=True), "fsdp": dict(fsdp=True),
         "tp_fsdp": dict(tp=True, fsdp=True)}


def _stub(**axes):
    return SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))


_TREES = {}


def _trees(arch):
    """(reference config, port config, reference shape tree, port tree)."""
    if arch not in _TREES:
        jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                   dtype="float32", vocab_size=128)
        tcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32", vocab_size=128)
        jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
        _TREES[arch] = (jcfg, tcfg, jp, convert.lm_to_torch(jp, tcfg, CPU))
    return _TREES[arch]


def _ref_by_path(jspecs):
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jrules.path_str(p): tuple(s) for p, s in flat}


def _port_by_path(tspecs):
    out = {}
    rules.map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tspecs)
    return out


def _assert_same_specs(tspecs, jspecs):
    """Every port leaf's spec is the reference's; a body layer
    (stack/body/<slot>/<layer>/...) the reference's stacked leaf's without
    its leading None."""
    want = _ref_by_path(jspecs)
    got = _port_by_path(tspecs)
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


@pytest.mark.parametrize("mesh", [m for m in MESHES if "model" in MESHES[m]])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    """(The rules read the model axis, the reference's too.)"""
    _, _, jp, tp = _trees(arch)
    stub = _stub(**MESHES[mesh])
    _assert_same_specs(rules.param_specs(tp, stub),
                       jrules.param_specs(jp, stub))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_param_specs_match_reference(arch, mesh, mode):
    jcfg, tcfg, jp, tp = _trees(arch)
    stub = _stub(**MESHES[mesh])
    _assert_same_specs(
        PAR.mesh_param_specs(tp, stub, cfg=tcfg, **MODES[mode]),
        jpar.mesh_param_specs(jp, stub, cfg=jcfg, **MODES[mode]))


def test_mesh_param_specs_errors_and_fallbacks_match_reference():
    """tests/test_parallel_2d.py:428-456: tp needs cfg; heads that do not
    divide keep attention replicated; FSDP on a mesh without "model"."""
    jcfg, tcfg, _, tp = _trees("qwen3-1.7b")
    stub = _stub(data=2, model=2)
    with pytest.raises(ValueError, match="cfg"):
        PAR.mesh_param_specs(tp, stub, tp=True)
    odd_j = dataclasses.replace(jcfg, n_heads=3, n_kv_heads=3)
    odd_t = dataclasses.replace(tcfg, n_heads=3, n_kv_heads=3)
    jp3 = jax.device_get(JT.init_params(jax.random.PRNGKey(0), odd_j))
    tp3 = convert.lm_to_torch(jp3, odd_t, CPU)
    got = PAR.mesh_param_specs(tp3, stub, cfg=odd_t, tp=True)
    _assert_same_specs(got, jpar.mesh_param_specs(jp3, stub, cfg=odd_j,
                                                  tp=True))
    mixer = got["stack"]["body"][0][0]["mixer"]
    for name in ("wq", "wk", "wv", "wo"):
        assert "model" not in tuple(mixer[name])
    data4 = PAR.mesh_param_specs(tp, _stub(data=4), cfg=tcfg, fsdp=True)
    assert tuple(data4["stack"]["body"][0][0]["ff"]["w_gate"]) == \
        ("data", None)


@pytest.mark.parametrize("case", [
    dict(mesh=dict(data=2, model=2), batch=8, ghost=4, gbn=True),
    dict(mesh=dict(data=2, model=2), batch=6, ghost=4, gbn=True),
    dict(mesh=dict(data=4), batch=8, ghost=4, gbn=True),
    dict(mesh=dict(data=4), batch=8, ghost=4, gbn=False),
    dict(mesh=dict(data=3), batch=8, ghost=4, gbn=False),
    dict(mesh=dict(pod=2, data=2, model=2), batch=16, ghost=4, gbn=True),
    dict(mesh=dict(data=1, model=4), batch=8, ghost=8, gbn=True,
         arch="qwen2-moe-a2.7b"),
    dict(mesh=dict(data=1, model=3), batch=8, ghost=8, gbn=True,
         arch="qwen2-moe-a2.7b"),
    dict(mesh=dict(data=2, model=2), batch=8, ghost=4, gbn=True,
         arch="qwen2-moe-a2.7b", batch_size=12),
])
def test_mesh_compatible_matches_reference(case):
    stub = _stub(**case["mesh"])
    kw = dict(batch_size=case["batch"], base_batch_size=case["batch"],
              ghost_batch_size=case["ghost"], use_gbn=case["gbn"])
    jcfg = tcfg = None
    if "arch" in case:
        jcfg, tcfg = _trees(case["arch"])[:2]
    b = case.get("batch_size", 0)
    want = jpar.mesh_compatible(JLB(**kw), stub, batch_size=b, cfg=jcfg)
    assert PAR.mesh_compatible(LargeBatchConfig(**kw), stub, batch_size=b,
                               cfg=tcfg) == want


def test_data_parallel_mesh_compatible_matches_reference():
    """The 1-D entry point: the general gate behind a check that ``axis``
    names a dp axis of the mesh."""
    from repro.train import data_parallel as jdp
    from repro_torch.train import data_parallel as tdp
    kw = dict(batch_size=8, base_batch_size=8, ghost_batch_size=4)
    for axes, b in ((dict(data=2), 0), (dict(data=2), 6),
                    (dict(data=2, model=2), 0)):
        stub = _stub(**axes)
        assert tdp.mesh_compatible(LargeBatchConfig(**kw), stub,
                                   batch_size=b) == \
            jdp.mesh_compatible(JLB(**kw), stub, batch_size=b)
    for mod, lb in ((jdp, JLB(**kw)), (tdp, LargeBatchConfig(**kw))):
        with pytest.raises(ValueError, match="not a data-parallel axis"):
            mod.mesh_compatible(lb, _stub(data=2, model=2), axis="model")


@pytest.mark.parametrize("mode", list(MODES))
def test_state_bytes_per_device_match_reference(mode):
    """Parameter and Adam-state bytes a rank, replicated and laid out by
    each mode's specs (FSDP shrinks the moments by ~dp_size)."""
    jcfg, tcfg, jp, tp = _trees("qwen3-1.7b")
    stub = _stub(data=2, model=2)
    jspecs = jpar.mesh_param_specs(jp, stub, cfg=jcfg, **MODES[mode])
    tspecs = PAR.mesh_param_specs(tp, stub, cfg=tcfg, **MODES[mode])
    assert PAR.state_bytes_per_device(tp, tspecs, stub) == \
        jpar.state_bytes_per_device(jp, jspecs, stub)
    jst, tst = jadam.init(jp), adam.init(tp)
    jos = jadam.AdamState(mu=jspecs, nu=jspecs, step=JP())
    tos = PAR.opt_state_specs(tspecs, "adam")
    assert PAR.state_bytes_per_device(tst, tos, stub) == \
        jpar.state_bytes_per_device(jst, jos, stub)
    full = PAR.state_bytes_per_device(
        tst, tree.map(lambda a: P(*([None] * a.dim())), tst), stub)
    assert full == jpar.state_bytes_per_device(
        jst, jax.tree.map(lambda _: JP(), jst), stub)


@pytest.mark.parametrize("axes", [dict(data=2, model=2), dict(data=4),
                                  dict(pod=2, data=2, model=2),
                                  dict(model=2)])
def test_mesh_helpers_match_reference(axes):
    stub = _stub(**axes)
    for name in ("dp_axes", "dp_size", "dp_spec_entry", "fsdp_axes"):
        assert getattr(tmesh, name)(stub) == getattr(jmesh, name)(stub), name
    for a in ("pod", "data", "model"):
        assert tmesh.axis_size(stub, a) == jmesh.axis_size(stub, a)
    if tmesh.dp_axes(stub):
        for g in (8, 6):
            for nd in (2, 3):
                assert tuple(rules.batch_spec(stub, g, nd)) == \
                    tuple(jrules.batch_spec(stub, g, nd))
    assert (tmesh.POD_AXIS, tmesh.DATA_AXIS, tmesh.MODEL_AXIS) == \
        (jmesh.POD_AXIS, jmesh.DATA_AXIS, jmesh.MODEL_AXIS)


def test_one_process_meshes():
    """A mesh of one rank needs no process group; ``global_array`` of it
    is the whole tensor, its own contiguous copy."""
    host = tmesh.make_host_mesh(device=CPU)
    assert host.shape == {"data": 1, "model": 1} and host.rank == 0
    assert host.group(("data", "model")) is None
    assert tmesh.make_local_mesh(device=CPU).shape == dict(jmesh.make_local_mesh(
        ).shape)
    assert dict(tmesh.make_data_mesh(device=CPU).shape) == {"data": 1}
    with pytest.raises(ValueError, match="do not factor into model=2"):
        tmesh.make_local_mesh(model=2, device=CPU)
    with pytest.raises(ValueError, match="do not factor into model=2"):
        jmesh.make_local_mesh(model=2)
    with pytest.raises(ValueError, match="3 devices do not factor"):
        tmesh.make_2d_mesh(3, model=2, device=CPU)
    with pytest.raises(ValueError, match="needs a world of 4"):
        tmesh.make_2d_mesh(4, device=CPU)
    x = torch.arange(12.0).reshape(3, 4).t()
    got = tmesh.global_array(host, x, P("data", "model"))
    assert torch.equal(got, x) and got.is_contiguous()
    assert rules.path_str(("stack", 0, "mixer")) == "stack/0/mixer"
    assert P("data", None) == ("data", None) and len(P()) == 0
    np.testing.assert_array_equal(
        tmesh.global_array(host, np.ones((2, 2)), P(None, None)).numpy(),
        np.ones((2, 2)))
