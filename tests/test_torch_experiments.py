"""The port's experiments subsystem held to the JAX package's
(``repro.experiments``) on the CPU.

- Specs: every registered sweep, at its defaults and reduced, expands to
  the reference's ``run_id``s and spec JSON; ``from_json`` round-trips.
- Schedules: ``BatchSchedule``, ``constant_lr`` and ``batch_size_increase``
  equal the reference's, errors included.
- Stores and views: records cross between the two ``ResultsStore``s, and
  the Table-1 / diffusion views and their text are identical.
- One run against the reference (kernels off and on): the port is given
  the reference's initial parameters and epoch permutations; every field
  that needs no RNG is equal, the train_loss, lr and distance series match
  to 1e-4 (rtol = atol), accuracies within 1/n_test.
- Batch growth: a ``batch_schedule`` run sets the ``train/batch_size``
  gauge to the reference's sequence of batch sizes.
- Resume and skip, the LM runner path, obs names, shards and meshes, and
  the CLI.
"""
import contextlib
import dataclasses
import io
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.configs.paper_models import F1_MNIST as JF1
from repro.core import large_batch as jlb
from repro.core import regime as jregime
from repro.experiments import cli as jcli
from repro.experiments import metrics as JM
from repro.experiments import registry as jregistry
from repro.experiments import runner as jrunner
from repro.experiments import spec as jspec
from repro.models import cnn as jcnn
from repro.obs import Observability as JObservability
from repro_torch.configs import paper_models as tpm
from repro_torch.core import large_batch as tlb
from repro_torch.core import regime as tregime
from repro_torch.experiments import cli as tcli
from repro_torch.experiments import metrics as TM
from repro_torch.experiments import registry as tregistry
from repro_torch.experiments import runner as trunner
from repro_torch.experiments import spec as tspec
from repro_torch.obs import Observability as TObservability

CPU = "cpu"
TOL = 1e-4          # series of a 30-step run, as the train-step tests hold


# ---------------------------------------------------------------------------
# the same spec in both packages
# ---------------------------------------------------------------------------


def _tiny(pkg, **kw):
    """The reference tests' tiny F1 spec (tests/test_experiments.py), built
    from ``pkg``'s classes."""
    (spec, lb, cfg_cls) = ((jspec, jlb, None) if pkg == "jax"
                           else (tspec, tlb, tpm.VisionModelConfig))
    model = dataclasses.replace(JF1, input_shape=(8, 8, 1),
                                hidden_sizes=(32,), ghost_batch_size=16)
    if cfg_cls is not None:
        model = cfg_cls(**dataclasses.asdict(model))
    base = dict(
        name="tiny", method="SB", model=model,
        data=spec.DataSpec(seed=0, n_train=512, n_test=128,
                           input_shape=(8, 8, 1)),
        lb=lb.LargeBatchConfig(batch_size=32, base_batch_size=32,
                               ghost_batch_size=16),
        base_lr=0.08, total_steps=30, drop_every=10, seed=3)
    base.update(kw)
    return spec.RunSpec(**base)


def _both(**kw):
    """(reference spec, port spec); a ``lb``/``batch_schedule`` given as a
    dict of fields is built in each package."""
    out = []
    for pkg, lb_mod, reg_mod in (("jax", jlb, jregime),
                                 ("torch", tlb, tregime)):
        k = dict(kw)
        if isinstance(k.get("lb"), dict):
            k["lb"] = lb_mod.LargeBatchConfig(**k["lb"])
        if isinstance(k.get("batch_schedule"), dict):
            k["batch_schedule"] = reg_mod.BatchSchedule(**k["batch_schedule"])
        out.append(_tiny(pkg, **k))
    return out


def _strip(records):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in records]


def _canon(r):
    return json.dumps({k: v for k, v in r.items() if k != "wall_s"},
                      sort_keys=True)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

SWEEP_CASES = [(name, kw) for name in sorted(jregistry.SWEEPS)
               for kw in ({}, {"steps": 120, "seeds": (0, 1)})] + [
    ("lm-smoke", {"arch": "falcon-mamba-7b", "steps": 8}),
    ("generalization-gap", {"use_mesh": "data"}),
    ("generalization-gap", {"use_mesh": True}),
    ("diffusion", {"use_mesh": "2d", "batches": (64, 256)}),
    ("batch-size-increase", {"large_batch": 4096, "small_batch": 128,
                             "ghost": 128, "steps": 48}),
]


@pytest.mark.parametrize("name,kw", SWEEP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SWEEP_CASES)])
def test_sweep_specs_match_reference(name, kw):
    want = jregistry.get_sweep(name, **kw).expand()
    got = tregistry.get_sweep(name, **kw).expand()
    assert [s.run_id for s in got] == [s.run_id for s in want]
    assert [s.to_json() for s in got] == [s.to_json() for s in want]
    assert [s.regime().total_steps for s in got] == \
        [s.regime().total_steps for s in want]
    for s in got:
        again = tspec.RunSpec.from_json(json.loads(json.dumps(s.to_json())))
        assert again.run_id == s.run_id and again.to_json() == s.to_json()
        if s.use_mesh != "data":        # which the JSON writes as True
            assert again == s


def test_registry_errors_and_paths():
    with pytest.raises(KeyError, match="unknown sweep"):
        tregistry.get_sweep("table-2")
    with pytest.raises(TypeError):
        tregistry.get_sweep("generalization-gap", stepz=3)
    a, b = _both()
    assert b.run_id == a.run_id
    assert tspec.replace_path(b, "lb.batch_size", 64).run_id == \
        jspec.replace_path(a, "lb.batch_size", 64).run_id
    assert tspec.replace_path(b, "lb.batch_size", 64).lb.batch_size == 64
    assert tspec.paper_model("resnet44-cifar10") == \
        tpm.PAPER_MODELS["resnet44-cifar10"]
    sweep = tspec.SweepSpec(name="s", base=b,
                            methods={"SB": {}, "LB": {"lb.batch_size": 128}},
                            grid={"base_lr": [0.05, 0.1]}, seeds=(0, 1))
    jsweep = jspec.SweepSpec(name="s", base=a,
                             methods={"SB": {}, "LB": {"lb.batch_size": 128}},
                             grid={"base_lr": [0.05, 0.1]}, seeds=(0, 1))
    assert [s.run_id for s in sweep.expand()] == \
        [s.run_id for s in jsweep.expand()]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = [(32, 1024, 100, 5.0, 16), (32, 1000, 100, 5.0, 16),
             (128, 4096, 16, 5.0, 128), (8, 8, 3, 2.0, 8), (7, 60, 5, 1.5, 1),
             (32, 128, 8, 2.0, 16)]


@pytest.mark.parametrize("args", SCHEDULES)
def test_batch_schedule_matches_reference(args):
    keys = ("base_batch", "max_batch", "grow_every", "grow_factor",
            "round_to")
    kw = dict(zip(keys, args))
    want, got = jregime.BatchSchedule(**kw), tregime.BatchSchedule(**kw)
    steps = range(0, 6 * kw["grow_every"] + 3)
    assert [got.batch_at(s) for s in steps] == [want.batch_at(s)
                                                 for s in steps]
    for total in (1, kw["grow_every"], 4 * kw["grow_every"] + 1, 500):
        assert list(got.phases(total)) == list(want.phases(total))
    assert all(b % kw["round_to"] == 0 for b in got.phases(500))


@pytest.mark.parametrize("kw,match", [
    (dict(base_batch=32, max_batch=1024, grow_every=100, round_to=0),
     "round_to"),
    (dict(base_batch=32, max_batch=8, grow_every=100, round_to=16),
     "max_batch")])
def test_batch_schedule_errors_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as want:
        jregime.BatchSchedule(**kw)
    with pytest.raises(ValueError, match=match) as got:
        tregime.BatchSchedule(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("small", [
    dict(base_lr=0.1, total_steps=300, drop_every=100, drop_factor=0.2),
    dict(base_lr=0.08, total_steps=48, drop_every=16, drop_factor=0.5,
         warmup_steps=4)])
def test_constant_lr_and_batch_size_increase_match_reference(small):
    jr, tr = jregime.Regime(**small), tregime.Regime(**small)
    jc, tc = jregime.constant_lr(jr), tregime.constant_lr(tr)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    steps = list(range(small["total_steps"]))
    np.testing.assert_array_equal([float(tc.lr_at(s)) for s in steps],
                                  [float(jc.lr_at(s)) for s in steps])
    (jc2, js), (tc2, ts) = (
        jregime.batch_size_increase(jr, base_batch=32, max_batch=1024,
                                    round_to=16),
        tregime.batch_size_increase(tr, base_batch=32, max_batch=1024,
                                    round_to=16))
    assert dataclasses.asdict(tc2) == dataclasses.asdict(jc2)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


# ---------------------------------------------------------------------------
# stores and views
# ---------------------------------------------------------------------------


def _records():
    t = list(range(1, 64))
    recs = [{"run_id": f"s{s}", "method": "SB", "batch_size": 32, "seed": s,
             "steps": 100, "final_acc": 0.8 + 0.02 * s, "train_acc": 0.9,
             "metrics": {"distance": [t, [2.0 * np.log(x) + 0.1 * s
                                          for x in t]]}} for s in (0, 1)]
    recs += [{"run_id": "lb", "method": "LB", "batch_size": 1024, "seed": 0,
              "steps": 3, "final_acc": 0.5, "train_acc": 0.6,
              "metrics": {"distance": [[1, 2, 3], [0.1, 0.15, 0.17]]}},
             {"run_id": "sb-long", "method": "SB", "batch_size": 32,
              "seed": 0, "steps": 2400, "final_acc": 0.9},
             {"run_id": "walk", "method": "walk", "batch_size": 64,
              "seed": 2, "metrics": {"distance": [t, [x ** 0.3 for x in t]]}},
             {"run_id": "lm", "method": "SB", "batch_size": 8, "seed": 0,
              "steps": 4, "final_ce": 4.1, "metrics": {}}]
    return recs


def test_results_stores_cross_read(tmp_path):
    recs = _records()
    tstore = TM.ResultsStore(str(tmp_path / "t"))
    jstore = JM.ResultsStore(str(tmp_path / "j"))
    for r in recs:
        tstore.append(r)
        jstore.append(r)
    assert (tmp_path / "t" / "records.jsonl").read_bytes() == \
        (tmp_path / "j" / "records.jsonl").read_bytes()
    assert JM.ResultsStore(str(tmp_path / "t")).records() == \
        TM.ResultsStore(str(tmp_path / "j")).records()
    assert tstore.completed_run_ids() == jstore.completed_run_ids()
    assert TM.ResultsStore(str(tmp_path / "none")).records() == []


@pytest.mark.parametrize("burn_in", [1, 2, 5])
def test_views_and_formats_match_reference(burn_in):
    recs = _records()
    acc = [r for r in recs if "final_acc" in r]
    same = lambda a, b: json.dumps(a) == json.dumps(b)    # noqa: E731 (NaN)
    assert same(TM.table1_view(acc), JM.table1_view(acc))
    rows = TM.table1_view(acc)
    for baseline in ("SB", "LB", None):
        assert TM.format_table1(rows, baseline) == \
            JM.format_table1(rows, baseline)
    assert same(TM.diffusion_view(recs, burn_in=burn_in),
                JM.diffusion_view(recs, burn_in=burn_in))
    assert TM.format_diffusion(TM.diffusion_view(recs, burn_in=burn_in)) == \
        JM.format_diffusion(JM.diffusion_view(recs, burn_in=burn_in))


# ---------------------------------------------------------------------------
# one run against the reference
# ---------------------------------------------------------------------------


def _feed_reference_rng(monkeypatch, jspec_):
    """Give the port's runner the reference's initial parameters and epoch
    permutations for ``jspec_`` (its RNG streams cannot match the
    reference's)."""
    from repro_torch import convert
    from repro_torch.models import cnn as tcnn
    from repro_torch.train import trainer as TR
    init_key, _, shuffle_key = jax.random.split(
        jax.random.PRNGKey(jspec_.seed), 3)
    jp, js = jcnn.model_fns(jspec_.model)[0](init_key, jspec_.model)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    real = tcnn.model_fns

    def model_fns(cfg):
        apply = real(cfg)[1]
        return (lambda seed, cfg, device: (convert.to_torch(jp, device),
                                           convert.to_torch(js, device)),
                apply)

    def epoch_perm(seed, epoch, n, device):
        perm = jax.random.permutation(jax.random.fold_in(shuffle_key, epoch),
                                      n)
        return torch.tensor(np.asarray(perm), device=device).long()

    monkeypatch.setattr(tcnn, "model_fns", model_fns)
    monkeypatch.setattr(TR, "_epoch_perm", epoch_perm)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_run_one_matches_reference(monkeypatch, use_kernels):
    jspec_, tspec_ = _both(eval_every=5, use_kernels=use_kernels)
    want = jrunner.run_one(jspec_)
    _feed_reference_rng(monkeypatch, jspec_)
    got = trunner.run_one(tspec_, device=CPU)
    assert set(got) == set(want)
    for k in ("run_id", "sweep", "method", "seed", "batch_size", "steps",
              "spec"):
        assert got[k] == want[k], k
    assert set(got["metrics"]) == set(want["metrics"]) == \
        {"val_acc", "train_loss", "lr", "distance"}
    for name, (steps, values) in want["metrics"].items():
        g_steps, g_values = got["metrics"][name]
        assert g_steps == steps, name
        tol = 1.0 / jspec_.data.n_test if name == "val_acc" else TOL
        np.testing.assert_allclose(g_values, values, rtol=tol, atol=tol,
                                   err_msg=name)
    for k in ("final_acc", "best_acc", "train_acc"):
        assert abs(got[k] - want[k]) <= 1.0 / jspec_.data.n_test, k
    for k in ("log_fit", "power_fit"):
        assert set(got[k]) == set(want[k])
        for f in got[k]:
            np.testing.assert_allclose(got[k][f], want[k][f], rtol=1e-3,
                                       atol=1e-3, err_msg=f"{k}.{f}")


def _batch_sizes(obs):
    """Every value the run sets its ``train/batch_size`` gauge to."""
    seen, real = [], obs.registry.set

    def record(name, v):
        if name == "train/batch_size":
            seen.append(int(v))
        real(name, v)

    obs.registry.set = record
    return seen


def test_batch_growth_visits_reference_batch_sizes():
    kw = dict(total_steps=20, drop_every=8,
              lb=dict(batch_size=128, base_batch_size=32, lr_rule="none",
                      ghost_batch_size=16, regime_adaptation=False),
              batch_schedule=dict(base_batch=32, max_batch=120, grow_every=8,
                                  grow_factor=2.0, round_to=16))
    jspec_, tspec_ = _both(**kw)
    jobs, tobs = JObservability(), TObservability()
    want, got = _batch_sizes(jobs), _batch_sizes(tobs)
    jrec = jrunner.run_one(jspec_, obs=jobs)
    trec = trunner.run_one(tspec_, obs=tobs, device=CPU)
    assert got == want == [32] * 8 + [64] * 8 + [112] * 4
    assert tobs.registry.gauge("train/batch_size").value == 112
    assert trec["steps"] == jrec["steps"] == 20
    assert trec["batch_size"] == jrec["batch_size"] == 32
    assert trec["run_id"] == jrec["run_id"]


# ---------------------------------------------------------------------------
# resume and skip (the port alone)
# ---------------------------------------------------------------------------

RESUME_CASES = {
    "plain": dict(total_steps=40, eval_every=10),
    "noise+kernels": dict(total_steps=40, eval_every=10, use_kernels=True,
                          lb=tlb.LargeBatchConfig(batch_size=64,
                                                  base_batch_size=32,
                                                  ghost_batch_size=16,
                                                  ghost_noise=0.5)),
    "batch-growth": dict(total_steps=24, eval_every=8, drop_every=8,
                         batch_schedule=tregime.BatchSchedule(
                             base_batch=32, max_batch=128, grow_every=8,
                             grow_factor=2.0, round_to=16)),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_killed_run_resumes_identically(tmp_path, case):
    spec = _tiny("torch", **RESUME_CASES[case])
    ref = trunner.run_one(spec, device=CPU)
    ck = str(tmp_path / "ck")
    calls = []

    def killer(msg):
        calls.append(msg)
        if len(calls) == 2:                     # after the second eval
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        trunner.run_one(spec, checkpoint_dir=ck, checkpoint_every=8,
                        log_fn=killer, device=CPU)
    assert os.path.exists(os.path.join(ck, "latest"))
    resumed = trunner.run_one(spec, checkpoint_dir=ck, checkpoint_every=8,
                              device=CPU)
    assert _canon(resumed) == _canon(ref)


def test_same_seed_same_record():
    spec = _tiny("torch", eval_every=10)
    a, b = (trunner.run_one(spec, device=CPU) for _ in range(2))
    assert _canon(a) == _canon(b)
    c = trunner.run_one(dataclasses.replace(spec, seed=4), device=CPU)
    assert c["metrics"] != a["metrics"]


def test_sweep_skips_on_resume_and_reaps_orphans(tmp_path):
    sweep = tspec.SweepSpec(name="tiny", base=_tiny("torch"),
                            methods={"SB": {}, "LB": {"lb.batch_size": 128}})
    recs = trunner.run_sweep(sweep, str(tmp_path), device=CPU)
    assert [r["method"] for r in recs] == ["SB", "LB"]
    assert all(0.0 <= r["final_acc"] <= 1.0 for r in recs)
    orphan = os.path.join(str(tmp_path), "tiny", "ckpt", recs[0]["run_id"])
    os.makedirs(orphan)
    seen, obs = [], TObservability()
    again = trunner.run_sweep(sweep, str(tmp_path), log_fn=seen.append,
                              obs=obs, device=CPU)
    assert _strip(again) == _strip(recs)
    assert len(seen) == 2 and all("skipping" in m for m in seen)
    assert not os.path.exists(orphan)
    assert obs.tracer.events == [] and obs.registry.names() == []
    assert len(TM.ResultsStore(str(tmp_path / "tiny")).records()) == 2
    fresh = trunner.run_sweep(sweep, str(tmp_path), resume=False, device=CPU)
    assert _strip(fresh) == _strip(recs)
    assert len(TM.ResultsStore(str(tmp_path / "tiny")).records()) == 2


def test_killed_sweep_restarts_to_identical_records(tmp_path):
    sweep = tspec.SweepSpec(
        name="killed", base=_tiny("torch", total_steps=24, eval_every=8),
        methods={"SB": {}, "LB": {"lb.batch_size": 128}})
    ref = _strip(trunner.run_sweep(sweep, str(tmp_path / "ref"),
                                   checkpoint_every=10, device=CPU))
    boom = str(tmp_path / "boom")
    _, lb_spec = sweep.expand()
    trunner.run_sweep(dataclasses.replace(sweep, methods={"SB": {}}), boom,
                      checkpoint_every=10, device=CPU)

    def killer(msg):
        if msg.startswith("step    16"):
            raise KeyboardInterrupt

    lb_ck = os.path.join(boom, sweep.name, "ckpt", lb_spec.run_id)
    with pytest.raises(KeyboardInterrupt):
        trunner.run_one(lb_spec, checkpoint_dir=lb_ck, checkpoint_every=10,
                        log_fn=killer, device=CPU)
    assert os.path.exists(os.path.join(lb_ck, "latest"))
    resumed = _strip(trunner.run_sweep(sweep, boom, checkpoint_every=10,
                                       device=CPU))
    assert resumed == ref
    assert not os.path.exists(lb_ck)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b",
                                  "qwen2-moe-a2.7b"])
def test_lm_runner_path(tmp_path, arch):
    # three steps: the kill at step 2's checkpoint leaves one to resume
    kw = dict(lm_arch=arch, lm_seq_len=16, lm_n_tokens=4096,
              lm_vocab_size=64, total_steps=3, drop_every=2, eval_every=2,
              track_diffusion=False, weight_decay=0.0, use_kernels=True,
              lb=dict(batch_size=8, base_batch_size=8, lr_rule="none",
                      use_gbn=False, ghost_noise=0.5))
    jspec_, spec = _both(**kw)
    assert spec.run_id == jspec_.run_id
    sweep = tspec.SweepSpec(name="lm", base=spec)
    recs = trunner.run_sweep(sweep, str(tmp_path / "a"), checkpoint_every=2,
                             device=CPU)
    spec, = sweep.expand()
    assert len(recs) == 1 and recs[0]["steps"] == 3
    assert np.isfinite(recs[0]["final_ce"])
    assert set(recs[0]["metrics"]) == {"eval_ce", "train_loss", "lr"}
    assert not os.path.exists(tmp_path / "a" / "lm" / "ckpt" / spec.run_id)

    ck = str(tmp_path / "ck")

    def killer(msg):
        if msg.startswith("step     2"):
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        trunner.run_one(spec, checkpoint_dir=ck, checkpoint_every=2,
                        log_fn=killer, device=CPU)
    resumed = trunner.run_one(spec, checkpoint_dir=ck, checkpoint_every=2,
                              device=CPU)
    assert _canon(resumed) == _canon(recs[0])


# ---------------------------------------------------------------------------
# obs, shards, meshes
# ---------------------------------------------------------------------------


def _names(obs):
    return ({e["name"] for e in obs.tracer.events},
            set(obs.registry.names()))


def test_obs_names_match_reference():
    jspec_, tspec_ = _both(total_steps=6)
    jobs, tobs = JObservability(), TObservability()
    jrunner.run_one(jspec_, obs=jobs)
    trunner.run_one(tspec_, obs=tobs, device=CPU)
    assert _names(tobs) == _names(jobs)
    reg = tobs.registry
    assert reg.counter("train/steps").value == 6
    assert reg.histogram("train/step_time_s").count == 6
    assert reg.histogram("train/distance").count >= 6


def test_obs_with_evaluations():
    """The reference raises TypeError here (its logger observes the logged
    ``lr`` into the ``train/lr`` gauge); the port's mirror sets the gauge."""
    _, tspec_ = _both(total_steps=6, eval_every=2)
    tobs = TObservability()
    trunner.run_one(tspec_, obs=tobs, device=CPU)
    spans, metrics = _names(tobs)
    assert spans == {"train.step", "train.eval"}
    assert {"train/val_acc", "train/train_loss", "train/lr",
            "train/batch_size", "train/steps"} <= metrics
    assert tobs.registry.histogram("train/val_acc").count == 3
    assert tobs.registry.gauge("train/lr").value > 0


def test_shard_owns_partitions_as_reference():
    ids = [_tiny("torch", seed=s).run_id for s in range(24)]
    for count in (1, 2, 3, 5):
        owners = [[r for r in ids if trunner._shard_owns(r, i, count)]
                  for i in range(count)]
        assert sorted(r for o in owners for r in o) == sorted(ids)
        assert owners == [[r for r in ids if jrunner._shard_owns(r, i, count)]
                          for i in range(count)]


def test_run_sweep_shards(tmp_path):
    sweep = tspec.SweepSpec(name="tiny", base=_tiny("torch", total_steps=2),
                            seeds=(0, 1, 2, 3))
    with pytest.raises(ValueError, match="bad sweep shard"):
        trunner.run_sweep(sweep, str(tmp_path), shard=(2, 2), device=CPU)
    got = [r["run_id"] for r in trunner.run_sweep(
        sweep, str(tmp_path), shard=(1, 2), device=CPU)]
    assert got == [s.run_id for s in sweep.expand()
                   if jrunner._shard_owns(s.run_id, 1, 2)]


@pytest.mark.parametrize("use_mesh", [True, "data", "2d"])
def test_mesh_request_warns_once_and_runs_on_one_device(use_mesh):
    jspec_, spec = _both(total_steps=2, use_mesh=use_mesh)
    topo = "data" if use_mesh is True else use_mesh
    trunner._DEGRADE_WARNED.clear()
    try:
        with pytest.warns(RuntimeWarning,
                          match=f"'{topo}'.*degrading to 'single-device'"):
            rec = trunner.run_one(spec, device=CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            trunner.run_one(spec, device=CPU)
    finally:
        trunner._DEGRADE_WARNED.clear()
    assert rec["run_id"] == jspec_.run_id and rec["steps"] == 2
    with pytest.raises(ValueError, match="unknown mesh topology"):
        trunner._mesh_for(dataclasses.replace(spec, use_mesh="3d"))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["list"], ["show", "generalization-gap"],
    ["show", "batch-size-increase", "--steps", "120", "--seeds", "2"],
    ["show", "lm-smoke", "--mesh"], ["show", "diffusion", "--mesh", "2d"]])
def test_cli_list_and_show_match_reference(argv):
    assert _stdout(tcli.main, argv) == _stdout(jcli.main, argv)


def test_cli_run_and_table(tmp_path):
    out = str(tmp_path / "runs")
    text = _stdout(tcli.main, ["run", "generalization-gap", "--steps", "6",
                               "--device", "cpu", "--out", out,
                               "--checkpoint-every", "4"])
    assert "5 records in" in text and "== Table-1 view ==" in text
    again = _stdout(tcli.main, ["run", "generalization-gap", "--steps", "6",
                                "--device", "cpu", "--out", out])
    assert again.count("skipping") == 5
    table = _stdout(tcli.main, ["table", "generalization-gap", "--out", out])
    assert "LB+LR+GBN+RA" in table
    # the reference's table over the port's records prints the same
    assert table == _stdout(jcli.main, ["table", "generalization-gap",
                                        "--out", out])
    assert "no records" in _stdout(tcli.main, ["table", "diffusion", "--out",
                                               out])
