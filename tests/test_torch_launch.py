"""The port's launchers and tooling on the CPU, held to the JAX package's:

- ``repro_torch.launch.train``'s loop, started from the reference's
  ``T.init_params(PRNGKey(0))`` parameters, against a loop of
  ``repro.train.trainer.make_lm_train_step`` with no mesh fed the same
  ``build_batches`` rows and ``RandomState(1)`` indices (the reference
  launcher's own mesh path fails on JAX 0.9): every step's loss and
  ``|w - w0|`` within 1e-5, with the single-device step and with the mesh
  step on the host mesh; ``--mesh`` and ``--parallel pjit`` exit with why;
- ``repro_torch.launch.serve`` in both modes with ``--device cpu`` writes
  a span trace and metrics whose names are the reference launcher's on the
  same arguments;
- ``device_trace`` writes a Chrome trace with the spans over the ops, and
  raises when a profiler is already running;
- ``python -m repro_torch.obs --label x -- python -c pass``;
- ``repro_torch.core.metrics.MetricsLogger`` is the obs class, and the
  port's import scan (tests/test_torch_port.py) covers the new modules.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from test_torch_port import PORT_FILES
from repro.configs.registry import get_config as jget_config
from repro.core import DiffusionTracker as JDiffusionTracker
from repro.core import LargeBatchConfig as JLargeBatchConfig
from repro.core import Regime as JRegime
from repro.launch import serve as jserve
from repro.launch import train as jlaunch
from repro.models import transformer as JT
from repro.optim import sgd as jsgd
from repro.train import trainer as jtrain
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import metrics as core_metrics
from repro_torch.launch import serve, train
from repro_torch.obs import Observability
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import device_trace

CPU = "cpu"
TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
TRAIN_ARGS = ["--arch", "qwen3-1.7b-reduced", "--steps", "4", "--batch", "8",
              "--base-batch", "8", "--seq-len", "16", "--log-every", "1",
              "--device", CPU]


def _reference_loop(args):
    """The reference launcher's host loop (repro/launch/train.py:112-160)
    with the no-mesh step: each step's loss and the tracker's records."""
    cfg = dataclasses.replace(jget_config(args.arch), dtype=args.dtype)
    lb = JLargeBatchConfig(
        batch_size=args.batch, base_batch_size=args.base_batch,
        lr_rule=args.lr_rule, regime_adaptation=args.ra,
        grad_clip=args.grad_clip, ghost_noise=args.ghost_noise)
    regime = lb.build_regime(JRegime(base_lr=args.base_lr,
                                     total_steps=args.steps,
                                     drop_every=max(1, args.steps // 3)))
    rng = jax.random.PRNGKey(0)
    params = JT.init_params(rng, cfg)
    params0 = jax.device_get(params)
    opt_state = jsgd.init(params)
    step_jit = jax.jit(jtrain.make_lm_train_step(cfg, lb, regime))
    seqs = jlaunch.build_batches(cfg, batch=args.batch, seq_len=args.seq_len,
                                 n_tokens=args.batch * args.seq_len * 64)
    nprng = np.random.RandomState(1)
    tracker = JDiffusionTracker(params)
    losses = []
    for step in range(regime.total_steps):
        idx = nprng.randint(0, seqs.shape[0], size=args.batch)
        params, opt_state, m = step_jit(
            params, opt_state, {"tokens": jnp.asarray(seqs[idx])},
            jnp.int32(step), jax.random.fold_in(rng, step))
        losses.append(float(m["loss"]))
        tracker.record(step + 1, params)
    return {"params0": params0, "seqs": seqs, "losses": losses,
            "steps": list(tracker.steps),
            "distances": [float(d) for d in tracker.distances]}


@pytest.fixture(scope="module")
def reference_run():
    return _reference_loop(train.parser().parse_args(TRAIN_ARGS))


@pytest.mark.parametrize("parallel", ["single", "shard_map"])
def test_train_loop_matches_the_reference_loop(reference_run, parallel,
                                               tmp_path):
    args = train.parser().parse_args(
        TRAIN_ARGS + ["--parallel", parallel, "--ckpt", str(tmp_path)])
    cfg = dataclasses.replace(get_config(args.arch), dtype=args.dtype)
    rows = train.build_batches(cfg, batch=args.batch, seq_len=args.seq_len,
                               n_tokens=args.batch * args.seq_len * 64)
    np.testing.assert_array_equal(rows, reference_run["seqs"])
    params = convert.lm_to_torch(reference_run["params0"], cfg, CPU)
    out = train.train(args, params=params)
    np.testing.assert_allclose(out["losses"], reference_run["losses"],
                               rtol=TOL, atol=TOL)
    assert out["steps"] == reference_run["steps"] == [1, 2, 3, 4]
    np.testing.assert_allclose(out["distances"], reference_run["distances"],
                               rtol=TOL, atol=TOL)
    assert (tmp_path / "latest").read_text() == "4"


def test_train_refuses_pod_meshes_and_gspmd(capsys):
    assert train.main(TRAIN_ARGS + ["--mesh", "single"]) == 2
    assert "pod meshes" in capsys.readouterr().err
    assert train.main(TRAIN_ARGS + ["--parallel", "pjit"]) == 2
    assert "GSPMD" in capsys.readouterr().err


def test_extra_inputs_draw_each_memory():
    gen = torch.Generator().manual_seed(3)
    enc = get_config("seamless-m4t-large-v2-reduced")
    out = train.extra_inputs(enc, 2, 16, gen)
    assert set(out) == {"frames"}
    assert out["frames"].shape == (2, 16 // enc.encoder.frame_ratio,
                                   enc.encoder.d_model)
    vis = get_config("llama-3.2-vision-11b-reduced")
    out = train.extra_inputs(vis, 2, 16, gen)
    assert out["image_embeds"].shape == (2, vis.vision.n_image_tokens,
                                         vis.d_model)
    assert train.extra_inputs(get_config("qwen3-1.7b-reduced"), 2, 16,
                              gen) == {}


SERVE_MODES = {
    "static": ["--batch", "2", "--max-new", "4", "--prompt-len", "8"],
    "continuous": ["--continuous", "--requests", "3", "--slots", "2",
                   "--max-new", "4", "--prompt-len", "8"],
}


def _names(trace, metrics):
    with open(trace) as f:
        spans = {e["name"] for e in json.load(f)}
    with open(metrics) as f:
        mets = {json.loads(line)["name"] for line in f}
    return spans, mets


def _heads(out):
    """The launcher's printed lines, each cut before its numbers."""
    return [line.split(" -> ")[0].split(":")[0] for line in out.splitlines()
            if line.startswith(("generated", "cold", "continuous", "static",
                                "wrote"))]


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_writes_the_reference_spans_and_metrics(mode, tmp_path,
                                                      monkeypatch, capsys):
    argv = SERVE_MODES[mode]
    want_t, want_m = tmp_path / "jt.json", tmp_path / "jm.jsonl"
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + [
        "--trace", str(want_t), "--metrics-out", str(want_m)])
    jserve.main()
    want_out = capsys.readouterr().out
    got_t, got_m = tmp_path / "t.json", tmp_path / "m.jsonl"
    serve.main(argv + ["--device", CPU, "--trace",
                       str(got_t), "--metrics-out", str(got_m)])
    got_out = capsys.readouterr().out
    assert _names(got_t, got_m) == _names(want_t, want_m)
    first = {"static": "generated ", "continuous": "continuous: "}[mode]
    assert first in got_out and first in want_out
    assert _heads(got_out) == _heads(want_out)


def test_device_trace_writes_spans_over_the_ops(tmp_path):
    obs = Observability(annotate_device=True)
    with device_trace(str(tmp_path)) as dt:
        with obs.span("serve.decode_step"):
            torch.ones(8).add_(1).sum()
    with open(dt.path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == "serve.decode_step"
                and e.get("ph") == "X")
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] == "aten::add_"]
    assert ops and all(span["ts"] <= e["ts"] <= span["ts"] + span["dur"]
                       for e in ops)


def test_device_trace_raises_when_a_profiler_runs(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="already running"):
            with device_trace(str(tmp_path)):
                pass


def test_obs_cli_wraps_a_command():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--label",
                          "x", "--", sys.executable, "-c", "pass"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[trace] x: ") and "(exit 0)" in out.stdout


def test_core_metrics_is_the_obs_logger():
    assert core_metrics.MetricsLogger is obs_metrics.MetricsLogger


def test_import_scan_covers_the_new_modules():
    port = ROOT / "src" / "repro_torch"
    for rel in ("launch/serve.py", "launch/train.py", "obs/__main__.py",
                "core/metrics.py", "sharding/rules.py"):
        assert port / rel in PORT_FILES
