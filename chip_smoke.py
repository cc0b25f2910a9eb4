#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits nonzero and prints no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. each GBN kernel against its plain PyTorch version on the card (f32) at
   the shapes of the ResNet44/F1 training path (B=4096, ghost 128) and at
   ragged shapes, plus a leftover-rows ``gbn_apply`` with live mu/var
   cotangents; times of kernel, plain version, ``F.batch_norm`` yardstick
   and the byte bound at the path's shapes;
4. ``train_vision`` on RESNET44_CIFAR10 at full width, B=4096, the
   LB+LR+GBN+RA recipe, through the CUDA GBN pair (5 steps; the launch
   counters must show 43 forward + 43 backward GBN calls per step), its
   step time, then a short F1_MNIST run at B=4096;
5. one reduced ResNet step on the card (kernels) against the same step on
   the CPU (plain versions) from the same parameters, TF32 off.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4               # as tests/test_kernels.py holds the Pallas kernels
LOSS_TOL = 1e-5          # as the reference's train-step equivalence tests
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
BATCH, GHOST = 4096, 128
STEPS = 5
# GBN (G, R, C) per ResNet44 layer at B=4096, ghost 128: the stem and the
# 14 convs of stage 1, then 14 in each of stages 2 and 3
RESNET_SHAPES = [((32, 131072, 16), 15), ((32, 32768, 32), 14),
                 ((32, 8192, 64), 14)]
F1_SHAPE = (32, 128, 512)
RAGGED_SHAPES = [(3, 77, 200), (1, 16, 8), (2, 33, 10)]
REPLACES = {"gbn_forward": "src/repro/kernels/gbn.py:121",
            "gbn_backward": "src/repro/kernels/gbn.py:167"}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def check_close(name: str, got, want, tol: float = TOL) -> float:
    """allclose(rtol=atol=tol); returns the max abs error."""
    err = max_err(got, want)
    got, want = got.detach().double(), want.detach().double()
    bad = ((got - want).abs() > tol + tol * want.abs()).any()
    log(f"  {name:<28} max_abs_err {err:.3e}  tol {tol:g} (rtol=atol)")
    if bool(bad):
        raise AssertionError(f"{name}: outside rtol=atol={tol}")
    return err


def check_sum(name: str, got, want, tol: float = TOL) -> float:
    """dgamma/dbeta sum over G*R rows in another order than the plain
    version: held to tol relative to the largest entry."""
    err = max_err(got, want)
    scale = max(1.0, float(want.detach().abs().max()))
    log(f"  {name:<28} max_abs_err {err:.3e}  tol {tol:g} x max|ref| "
        f"{scale:.3g}")
    if err > tol * scale:
        raise AssertionError(f"{name}: error {err} > {tol} x {scale}")
    return err


def time_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fwd_work(G, R, C):
    # read x, gamma, beta; write y, mu, var. ~8 flops an element
    return 4.0 * (2 * G * R * C + 2 * G * C + 2 * C), 8.0 * G * R * C


def bwd_work(G, R, C):
    # read x, dy, gamma, mu, var, dmu, dvar; write dx, dgamma, dbeta
    return 4.0 * (3 * G * R * C + 4 * G * C + 3 * C), 10.0 * G * R * C


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {build.SOURCES} with nvcc {' '.join(build.NVCC_FLAGS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")


def gbn_inputs(shape, seed):
    import torch
    G, R, C = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    x = 2.0 * randn(G, R, C) + 0.5
    gamma = torch.linspace(0.5, 1.5, C, device="cuda")
    beta = torch.linspace(-1.0, 1.0, C, device="cuda")
    return x, gamma, beta, (randn(G, R, C), randn(G, C), randn(G, C))


def phase_kernels(rows):
    """Kernel vs plain at every shape; times at the path's shapes. Fills
    ``rows[shape] = {...}`` with the measurements."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gbn as K
    from repro_torch.kernels import ref
    errs = {"gbn_forward": 0.0, "gbn_backward": 0.0}
    timed = [s for s, _ in RESNET_SHAPES] + [F1_SHAPE]
    for i, shape in enumerate(timed + RAGGED_SHAPES):
        G, R, C = shape
        log(f"kernel check {shape}  geometry {K.geometry(G, R, C)}")
        x, gamma, beta, (dy, dmu, dvar) = gbn_inputs(shape, i)
        y, mu, var = K.gbn_forward(x, gamma, beta)
        yr, mur, varr = ref.gbn_ref(x, gamma, beta)
        torch.cuda.synchronize()
        errs["gbn_forward"] = max(
            errs["gbn_forward"], check_close("forward y", y, yr),
            check_close("forward mu", mu, mur),
            check_close("forward var", var, varr))
        del y, yr
        dx, dg, db = K.gbn_backward(x, gamma, mur, varr, dy, dmu, dvar)
        dxr, dgr, dbr = ref.gbn_backward_ref(x, gamma, mur, varr, dy, dmu,
                                             dvar)
        torch.cuda.synchronize()
        errs["gbn_backward"] = max(
            errs["gbn_backward"], check_close("backward dx", dx, dxr),
            check_sum("backward dgamma", dg, dgr),
            check_sum("backward dbeta", db, dbr))
        del dx, dxr
        if shape not in timed:
            continue
        # yardstick: one library call over the (1, G*C, R) ghost view (the
        # layout copy is made outside the timing)
        xl = x.transpose(1, 2).reshape(1, G * C, R).contiguous()
        dyl = dy.transpose(1, 2).reshape(1, G * C, R).contiguous()
        gl, bl = gamma.repeat(G), beta.repeat(G)
        _, smean, sinv = torch.ops.aten.native_batch_norm(
            xl, gl, bl, None, None, True, 0.1, 1e-5)
        row = {
            "fwd_ms": time_ms(lambda: K.gbn_forward(x, gamma, beta)),
            "fwd_plain_ms": time_ms(lambda: ref.gbn_ref(x, gamma, beta)),
            "fwd_library_ms": time_ms(lambda: F.batch_norm(
                xl, None, None, gl, bl, training=True, eps=1e-5)),
            "bwd_ms": time_ms(lambda: K.gbn_backward(
                x, gamma, mur, varr, dy, dmu, dvar)),
            "bwd_plain_ms": time_ms(lambda: ref.gbn_backward_ref(
                x, gamma, mur, varr, dy, dmu, dvar)),
            "bwd_library_ms": time_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dyl, xl, gl, None, None, smean, sinv, True, 1e-5,
                    [True, True, True])),
        }
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(*fwd_work(*shape))
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(*bwd_work(*shape))
        rows[shape] = row
        log("  timing " + json.dumps({k: (round(v, 4) if isinstance(v, float)
                                          else v) for k, v in row.items()}))
        del xl, dyl, x, dy
        torch.cuda.empty_cache()
    return errs


def phase_leftover_rows():
    """gbn_apply with B % ghost != 0: the tail is normalized with the last
    ghost's statistics, so the kernel's mu/var outputs carry gradient.
    Returns the max abs errors of the forward and the backward."""
    import torch
    from repro_torch.core.gbn import gbn_apply, gbn_init
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = 2.0 * torch.randn(300, 8, 8, 16, generator=gen, device="cuda") + 1.0
    w = torch.randn(300, 8, 8, 16, generator=gen, device="cuda")
    p0, s0 = gbn_init(16, torch.device("cuda"))
    p0 = {k: v + 0.1 * torch.randn(16, generator=gen, device="cuda")
          for k, v in p0.items()}
    outs = []
    for use_kernels in (True, False):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        xi = x.clone().requires_grad_(True)
        y, ns = gbn_apply(p, s0, xi, ghost_batch_size=128,
                          use_kernels=use_kernels)
        grads = torch.autograd.grad((y * w).sum(), (xi, p["gamma"],
                                                    p["beta"]))
        outs.append((y, ns, grads))
    (y1, s1, g1), (y2, s2, g2) = outs
    log("leftover rows: gbn_apply (300, 8, 8, 16), ghost 128, kernels vs "
        "plain")
    fwd = max([check_close("y", y1, y2)]
              + [check_close(k, s1[k], s2[k]) for k in ("mu_run", "var_run")])
    bwd = max(check_close("dx", g1[0], g2[0]),
              check_sum("dgamma", g1[1], g2[1]),
              check_sum("dbeta", g1[2], g2[2]))
    return fwd, bwd


def phase_train(cfg_name: str, cfg, data_shape, launches_per_step: int):
    import torch
    from repro_torch.core import Regime, presets
    from repro_torch.data import teacher_classification
    from repro_torch.kernels import gbn as K
    from repro_torch.models.cnn import model_fns
    from repro_torch.train.trainer import train_vision
    data = teacher_classification(0, n_train=2 * BATCH, n_test=2048,
                                  input_shape=data_shape)
    lb = presets(BATCH, 128, GHOST)["LB+LR+GBN+RA"]
    regime = lb.build_regime(Regime(base_lr=0.1, total_steps=STEPS,
                                    drop_every=3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = train_vision(model_fns(cfg), cfg, data, lb, regime, eval_every=1,
                       use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    losses = out["history"]["train_loss"]
    log(f"train_vision {cfg_name}: B={BATCH} ghost={GHOST} steps="
        f"{out['steps']} wall {wall:.2f} s (incl. {STEPS + 2} evals) "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB  losses {losses}  final_acc {out['final_acc']:.4f}")
    log(f"  launches {launches}")
    want = launches_per_step * STEPS
    if launches != {"gbn_forward": want, "gbn_backward": want}:
        raise AssertionError(f"{cfg_name}: GBN launches {launches}, want "
                             f"{want} forward and {want} backward")
    if out["steps"] != STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg_name}: bad run {out['steps']} {losses}")
    return launches, data, lb, regime


def phase_step_time(cfg_name, cfg, data, lb, regime):
    """Warm step time of the train step alone (host clock around a
    synchronized step), and the device time by kernel family."""
    import torch
    from repro_torch.models.cnn import model_fns
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_vision_train_step
    init, apply = model_fns(cfg)
    params, state = init(0, cfg, "cuda")
    opt = sgd.init(params)
    step = make_vision_train_step(apply, cfg, lb, regime, use_kernels=True)
    x = torch.as_tensor(data.x_train[:BATCH], device="cuda")
    y = torch.as_tensor(data.y_train[:BATCH], device="cuda").long()
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, opt, m = step(params, state, opt, x, y, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"step time {cfg_name}: ms per step {[round(t, 2) for t in times]} "
        f"(first includes cuDNN set-up)")
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, opt, m = step(params, state, opt, x, y, 4)
            torch.cuda.synchronize()
        fam, per_kernel = {}, []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
            if not t or ev.device_type.name != "CUDA":
                continue
            n = ev.key.lower()
            k = ("gbn" if "gbn_" in n else "conv" if any(
                s in n for s in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                                 "dgrad", "sm90", "gemm")) else "other")
            fam[k] = fam.get(k, 0.0) + t / 1e3
            per_kernel.append((t / 1e3, ev.count, k, ev.key[:70]))
        busy = sum(fam.values())
        log(f"  profile {cfg_name}: device ms by family "
            f"{ {k: round(v, 3) for k, v in fam.items()} }; busy {busy:.3f} "
            f"ms of a {times[-1]:.3f} ms step (idle share "
            f"{1 - busy / times[-1]:.3f})")
        for t, count, k, name in sorted(per_kernel, reverse=True)[:12]:
            log(f"    {t:9.3f} ms  x{count:<4d} {k:<5} {name}")
        for t, count, k, name in sorted(per_kernel, reverse=True):
            if k == "gbn":
                log(f"    gbn {t:9.3f} ms  x{count:<4d} {name}")
    except Exception as e:   # a measurement aid only; the checks stand
        log(f"  profile {cfg_name}: not available ({e!r})")
    return sorted(times[1:])[len(times[1:]) // 2]


def phase_cuda_vs_cpu():
    """One reduced ResNet step: card (CUDA kernels, cuDNN, TF32 off) vs CPU
    (plain versions) from the same parameters and batch."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import RESNET44_CIFAR10
    from repro_torch.core import Regime, presets
    from repro_torch.data import teacher_classification
    from repro_torch.models.cnn import model_fns
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_vision_train_step
    cfg = dataclasses.replace(RESNET44_CIFAR10, blocks_per_stage=1)
    B = 256
    data = teacher_classification(3, n_train=B, n_test=16,
                                  input_shape=(32, 32, 3))
    lb = presets(B, 128, GHOST)["LB+LR+GBN+RA"]
    regime = lb.build_regime(Regime(base_lr=0.1, total_steps=2,
                                    drop_every=1))
    init, apply = model_fns(cfg)
    p_cpu, s_cpu = init(0, cfg, "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree.map(lambda t: t.to(dev), p_cpu)
        s = tree.map(lambda t: t.to(dev), s_cpu)
        o = sgd.init(p)
        step = make_vision_train_step(apply, cfg, lb, regime,
                                      use_kernels=True)
        x = torch.as_tensor(data.x_train, device=dev)
        y = torch.as_tensor(data.y_train, device=dev).long()
        losses = []
        for i in range(2):
            p, s, o, m = step(p, s, o, x, y, i)
            losses.append(m["loss"].cpu())
        runs[dev] = (torch.stack(losses), p, s, o.momentum)
    log(f"cuda vs cpu: reduced ResNet (16/32/64, 1 block a stage), B={B}, "
        f"2 steps, tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    (lc, pc, sc, mc), (lh, ph, sh, mh) = runs["cuda"], runs["cpu"]
    check_close("loss", lc, lh, LOSS_TOL)
    for name, a, b in (("params", pc, ph), ("bn_state", sc, sh),
                       ("momentum", mc, mh)):
        err = max(max_err(x.cpu().float(), y.float())
                  for x, y in zip(tree.leaves(a), tree.leaves(b)))
        bad = any(bool(((x.cpu().double() - y.double()).abs()
                        > TOL + TOL * y.double().abs()).any())
                  for x, y in zip(tree.leaves(a), tree.leaves(b)))
        log(f"  {name:<28} max_abs_err {err:.3e}  tol {TOL:g} (rtol=atol)")
        if bad:
            raise AssertionError(f"cuda vs cpu {name} outside {TOL}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import F1_MNIST, RESNET44_CIFAR10
        from repro_torch.device import resolve_device
        resolve_device(None)
        smi = smi_line()
        log(f"card: {smi}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; tf32 matmul="
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
            f"{torch.backends.cudnn.allow_tf32}")
        phase_build()
        rows = {}
        errs = phase_kernels(rows)
        fwd_err, bwd_err = phase_leftover_rows()
        errs["gbn_forward"] = max(errs["gbn_forward"], fwd_err)
        errs["gbn_backward"] = max(errs["gbn_backward"], bwd_err)
        launches, data, lb, regime = phase_train(
            "resnet44-cifar10", RESNET44_CIFAR10, (32, 32, 3), 43)
        step_ms = phase_step_time("resnet44-cifar10", RESNET44_CIFAR10,
                                  data, lb, regime)
        del data
        phase_train("f1-mnist", F1_MNIST, (28, 28, 1), 4)
        phase_cuda_vs_cpu()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    # per ResNet44 step: the 43 GBN calls at their three shapes
    kernels = []
    for name, pre in (("gbn_forward", "fwd"), ("gbn_backward", "bwd")):
        tot = {k: sum(rows[s][f"{pre}_{k}"] * n for s, n in RESNET_SHAPES)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        work = fwd_work if pre == "fwd" else bwd_work
        nbytes = sum(work(*s)[0] * n for s, n in RESNET_SHAPES)
        flops = sum(work(*s)[1] * n for s, n in RESNET_SHAPES)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gbn.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": bound_ms(nbytes, flops)[0],
            "bound_by": bound_ms(nbytes, flops)[1],
            "library_ms": tot["library_ms"]})
    log(f"resnet44 step (B={BATCH}): median warm step {step_ms:.2f} ms; "
        f"GBN kernels {kernels[0]['ms'] + kernels[1]['ms']:.3f} ms a step "
        f"(bound {kernels[0]['bound_ms'] + kernels[1]['bound_ms']:.3f} ms)")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
