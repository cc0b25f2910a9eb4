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
   the CPU (plain versions) from the same parameters, TF32 off;
6. each serving kernel (rmsnorm_residual, swiglu, flash_attention,
   flash_decode) against its plain version on the card: at the full-width
   qwen3-1.7b shapes of phase 7 in bf16 (BF16_TOL) and at small f32
   shapes (TOL), ring/window decode included; device times of kernel,
   plain version and one library call, and the bound, at phase 7's shapes;
7. full-width qwen3-1.7b ``generate`` in bf16 (random weights from
   SERVE_SEED): B=8 left-padded prompts of width 512 (PROMPT_LENS),
   greedy, 32 new tokens. The launch counters must show 28
   flash_attention, 868 flash_decode, 896 rmsnorm_residual and 896 swiglu
   launches; rows 0 and 7 must equal their unpadded runs. Prefill ms,
   decode ms a step, tokens/s, peak memory, and a profiled decode step
   and prefill;
8. reduced qwen3 in f32 on the card against the CPU from the same
   parameters: greedy tokens equal, prefill logits within TOL.

The second-to-last line is a JSON object with one entry per kernel (GBN
per ResNet44 step, the serving kernels per ``generate``); the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
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


# ---------------------------------------------------------------------------
# serving: qwen3-1.7b generate (flash prefill, flash decode, fused
# rmsnorm+residual, fused SwiGLU)
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3-1.7b"
SERVE_SEED = 0
SERVE_B, SERVE_P, SERVE_NEW = 8, 512, 32
PROMPT_LENS = (512, 448, 384, 320, 256, 192, 128, 64)
BF16_TOL = 2e-2      # kernel vs plain in bf16: a few bf16 ulps (rtol=atol)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
SERVE_KERNELS = {
    # name: (source, TPU kernel it replaces)
    "rmsnorm_residual": ("rmsnorm_residual.cu",
                         "src/repro/kernels/fused_norm.py:77"),
    "swiglu": ("swiglu.cu", "src/repro/kernels/swiglu.py:87"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:187"),
    "flash_decode": ("flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:157"),
}


def profile_device_ms(fn, reps: int = 10):
    """Device time per call of everything ``fn`` launches (torch.profiler,
    after one warm call), and the kernels by name. None when the profiler
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0.0))
        if t and ev.device_type.name == "CUDA":
            kernels.append((t / 1e3 / reps, ev.count // reps, ev.key))
    total = sum(k[0] for k in kernels)
    return (total if total > 0 else None), kernels


def kernel_ms(fn, reps: int = 10) -> float:
    """Device ms per call (profiler); CUDA events around back-to-back calls
    where the profiler shows no device time."""
    ms, _ = profile_device_ms(fn, reps)
    return ms if ms is not None else time_ms(fn, reps)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def norm_work(N, d, esize=2):
    # read x, r, scale; write y, s; ~5 f32 ops an element
    return esize * 4 * N * d + 4 * d, 5.0 * N * d, F32_FLOPS


def swiglu_work(N, d, F, esize=2):
    # read x, wg, wu; write h, g; two products of 2 N d F
    return esize * (N * d + 2 * d * F + 2 * N * F), 4.0 * N * d * F, \
        BF16_FLOPS


def visible_pairs(T, lens):
    """(query, key) pairs a causal prefill of left-padded rows must score."""
    return sum(L * (L + 1) // 2 for L in lens)


def attn_work(B, H, KV, T, hd, lens, esize=2):
    # read q, k, v; write o; QK^T and PV over the visible pairs
    nbytes = esize * (2 * B * H * T * hd + 2 * B * KV * T * hd)
    return nbytes, 4.0 * hd * H * visible_pairs(T, lens), BF16_FLOPS


def decode_work(B, H, KV, hd, visible, esize=2):
    # read q and the visible K/V slots of every row; write o
    nbytes = esize * (2 * B * H * hd + 2 * KV * hd * sum(visible))
    return nbytes, 4.0 * hd * H * sum(visible), BF16_FLOPS


def serve_offsets(lens, P):
    import torch
    return torch.tensor([P - L for L in lens], device="cuda",
                        dtype=torch.int32)


def phase_serving_kernels():
    """Each serving kernel against its plain version on the card: at the
    full-width shapes of the generate run in bf16 (tolerance BF16_TOL) and
    at a small f32 shape (TOL), with ring/window decode at a small shape.
    Times (device ms per call) of kernel, plain version and library call at
    the full-width shapes. Returns {name: {"err": .., shape: {...}}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import ref
    from repro_torch.kernels import swiglu as SW
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)
    d, Fh, H, KV, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    B, P = SERVE_B, SERVE_P
    S = P + SERVE_NEW
    gen = torch.Generator(device="cuda").manual_seed(11)
    randn = lambda *s, dt=torch.bfloat16, sc=1.0: (  # noqa: E731
        sc * torch.randn(*s, generator=gen, device="cuda")).to(dt)
    out = {k: {"err": 0.0} for k in SERVE_KERNELS}

    def record(name, label, got, want, tol):
        e = check_close(f"{name} {label}", got.float(), want.float(), tol)
        out[name]["err"] = max(out[name]["err"], e)

    def timed(name, key, kern, plain, library, work):
        row = {"ms": kernel_ms(kern), "plain_ms": kernel_ms(plain)}
        try:     # a yardstick only: the port never calls it
            row["library_ms"] = kernel_ms(library)
        except Exception as e:
            log(f"  library yardstick of {name} failed: {e!r}")
            row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound(*work)
        row["work"] = work
        out[name][key] = row
        log(f"  timing {name} {key}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in row.items() if k != "work"}))

    # rmsnorm_residual -------------------------------------------------------
    log("kernel check rmsnorm_residual")
    scale = torch.linspace(0.5, 1.5, d, device="cuda")
    scale_bf = scale.bfloat16()
    for N in (P * B, B):
        x, r = randn(N, d), randn(N, d)
        record("rmsnorm_residual", f"({N}, {d}) bf16",
               torch.cat(FN.rmsnorm_residual(x, r, scale)),
               torch.cat(ref.rmsnorm_residual_ref(x, r, scale)), BF16_TOL)
        timed("rmsnorm_residual", N,
              lambda: FN.rmsnorm_residual(x, r, scale),
              lambda: ref.rmsnorm_residual_ref(x, r, scale),
              lambda: F.rms_norm(x + r, (d,), scale_bf, 1e-6),
              norm_work(N, d))
    x, r = randn(17, 128, dt=torch.float32), randn(17, 128, dt=torch.float32)
    s128 = torch.linspace(0.5, 1.5, 128, device="cuda")
    record("rmsnorm_residual", "(17, 128) f32",
           torch.cat(FN.rmsnorm_residual(x, r, s128)),
           torch.cat(ref.rmsnorm_residual_ref(x, r, s128)), TOL)

    # swiglu -------------------------------------------------------------------
    log("kernel check swiglu")
    wg, wu = randn(d, Fh, sc=d ** -0.5), randn(d, Fh, sc=d ** -0.5)
    for N in (P * B, B):
        x = randn(N, d)
        record("swiglu", f"({N}, {d}->{Fh}) bf16",
               torch.cat(SW.swiglu(x, wg, wu)),
               torch.cat(ref.swiglu_ref(x, wg, wu)), BF16_TOL)
        timed("swiglu", N, lambda: SW.swiglu(x, wg, wu),
              lambda: ref.swiglu_ref(x, wg, wu),
              lambda: F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu),
              swiglu_work(N, d, Fh))
    x = randn(33, 256, dt=torch.float32)
    w1, w2 = (randn(256, 384, dt=torch.float32, sc=1 / 16) for _ in range(2))
    record("swiglu", "(33, 256->384) f32", torch.cat(SW.swiglu(x, w1, w2)),
           torch.cat(ref.swiglu_ref(x, w1, w2)), TOL)
    del wg, wu, x

    # flash_attention ----------------------------------------------------------
    log("kernel check flash_attention")
    q = randn(B, H, P, hd)
    k, v = randn(B, KV, P, hd), randn(B, KV, P, hd)
    off = serve_offsets(PROMPT_LENS, P)
    record("flash_attention", f"B={B} H={H} KV={KV} T=S={P} hd={hd} ragged "
           f"bf16", FA.flash_attention_fwd(q, k, v, kv_offsets=off),
           ref.attention_ref(q, k, v, kv_offsets=off), BF16_TOL)
    keys = torch.arange(P, device="cuda")
    mask = ((keys[None, :] <= keys[:, None])[None]
            & (keys[None, None, :] >= off[:, None, None].long()))[:, None]
    timed("flash_attention", P,
          lambda: FA.flash_attention_fwd(q, k, v, kv_offsets=off),
          lambda: ref.attention_ref(q, k, v, kv_offsets=off),
          lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 enable_gqa=True),
          attn_work(B, H, KV, P, hd, PROMPT_LENS))
    qs = randn(2, 4, 100, 64, dt=torch.float32)
    ks_, vs_ = (randn(2, 2, 100, 64, dt=torch.float32) for _ in range(2))
    o2 = torch.tensor([0, 37], device="cuda", dtype=torch.int32)
    record("flash_attention", "(2, 4, 2, 100, 100, 64) f32 ragged window 13",
           FA.flash_attention_fwd(qs, ks_, vs_, window=13, kv_offsets=o2),
           ref.attention_ref(qs, ks_, vs_, window=13, kv_offsets=o2), TOL)
    del q, k, v, mask

    # flash_decode -------------------------------------------------------------
    log("kernel check flash_decode")
    q = randn(B, H, hd)
    k, v = randn(B, KV, S, hd), randn(B, KV, S, hd)
    theta = cfg.rope_theta
    first, last = P, S - 2              # the decode steps' positions
    per_row = torch.arange(first, first + B, device="cuda",
                           dtype=torch.int32)
    for label, pos in ((f"pos {first}", first), (f"pos {last}", last),
                       ("per-row pos", per_row)):
        record("flash_decode", f"B={B} H={H} KV={KV} S={S} hd={hd} {label} "
               f"ragged rope bf16",
               FD.flash_decode(q, k, v, pos, offsets=off, rope_theta=theta),
               ref.flash_decode_ref(q, k, v, pos, offsets=off,
                                    rope_theta=theta), BF16_TOL)
    for pos in (first, last):
        vis = [pos - (P - L) + 1 for L in PROMPT_LENS]
        slots = torch.arange(S, device="cuda")
        dmask = ((slots[None, :] <= pos)
                 & (slots[None, :] >= off[:, None].long()))[:, None, None]
        qr = ref.rope_rotate(q, (pos - off.long())[:, None].expand(B, H),
                             theta).bfloat16()[:, :, None]
        timed("flash_decode", pos,
              lambda: FD.flash_decode(q, k, v, pos, offsets=off,
                                      rope_theta=theta),
              lambda: ref.flash_decode_ref(q, k, v, pos, offsets=off,
                                           rope_theta=theta),
              lambda: F.scaled_dot_product_attention(
                  qr, k, v, attn_mask=dmask, enable_gqa=True),
              decode_work(B, H, KV, hd, vis))
    for ring, window, S2 in ((True, 16, 16), (False, 24, 70)):
        q2 = randn(3, 8, 64, dt=torch.float32)
        k2, v2 = (randn(3, 2, S2, 64, dt=torch.float32) for _ in range(2))
        o3 = torch.tensor([0, 3, 9], device="cuda", dtype=torch.int32)
        for pos in (9, 40, torch.tensor([12, 30, 9], device="cuda")):
            where = pos if isinstance(pos, int) else "per-row"
            record("flash_decode", f"(3, 8, 2, S={S2}, 64) f32 ring={ring} "
                   f"window={window} pos={where}",
                   FD.flash_decode(q2, k2, v2, pos, window=window, ring=ring,
                                   offsets=o3, rope_theta=1e4),
                   ref.flash_decode_ref(q2, k2, v2, pos, window=window,
                                        ring=ring, offsets=o3,
                                        rope_theta=1e4), TOL)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def ragged_prompts(vocab: int, seed: int):
    """(B, P) left-padded prompts of PROMPT_LENS real tokens, from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    full = torch.randint(0, vocab, (SERVE_B, SERVE_P), generator=g)
    lens = torch.tensor(PROMPT_LENS)
    real = torch.arange(SERVE_P)[None] >= SERVE_P - lens[:, None]
    return torch.where(real, full, 0).cuda()


def serving_launches():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import swiglu as SW
    return {**FA.launches, **FD.launches, **FN.launches, **SW.launches}


def reset_serving_launches():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import swiglu as SW
    for m in (FA, FD, FN, SW):
        m.reset_launches()


def family(name: str) -> str:
    n = name.lower()
    for fam in ("flash_decode", "flash_fwd", "swiglu", "rmsnorm_residual"):
        if fam in n:
            return fam
    if any(s in n for s in ("gemm", "gemv", "sm90", "cutlass", "xmma",
                            "cublas", "nvjet")):
        return "cublas_gemm"
    return "other"


def phase_serve():
    """Full-width qwen3-1.7b generate in bf16 on one card, random weights
    from SERVE_SEED: B=8 left-padded prompts of width 512 (PROMPT_LENS),
    greedy, 32 new tokens, through the four serving kernels."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate, make_serve_step, prefill_fused
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = TT.init_params(SERVE_SEED, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    log(f"serve {SERVE_ARCH}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.head_dim} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = ragged_prompts(cfg.vocab_size, SERVE_SEED + 1)
    kw = dict(max_new_tokens=SERVE_NEW, prompt_lens=PROMPT_LENS)
    generate(params, cfg, prompts, **kw)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serving_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = serving_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, n = cfg.n_layers, SERVE_NEW
    want = {"flash_attention": L, "flash_decode": L * (n - 1),
            "rmsnorm_residual": L * n, "swiglu": L * n}
    log(f"  generate: out {tuple(out.shape)} wall {wall * 1e3:.1f} ms "
        f"({SERVE_B * n / wall:.1f} new tokens/s end to end), peak memory "
        f"{peak:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"serving launches {launches}, want {want}")
    if tuple(out.shape) != (SERVE_B, SERVE_P + n):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool((out[:, SERVE_P:] < cfg.vocab_size).all()) or \
            not bool((out[:, SERVE_P:] >= 0).all()):
        raise AssertionError("generated ids outside the vocabulary")
    if not torch.equal(out[:, :SERVE_P], prompts):
        raise AssertionError("generate changed the prompts")
    for b in (0, SERVE_B - 1):
        Lb = PROMPT_LENS[b]
        solo = generate(params, cfg, prompts[b:b + 1, SERVE_P - Lb:],
                        max_new_tokens=n)
        same = torch.equal(solo[0, Lb:], out[b, SERVE_P:])
        log(f"  row {b} (prompt {Lb}) alone unpadded: "
            f"{'equal' if same else 'DIFFERENT'}; batch "
            f"{out[b, SERVE_P:SERVE_P + 8].tolist()}... solo "
            f"{solo[0, Lb:Lb + 8].tolist()}...")
        if not same:
            raise AssertionError(f"row {b} differs from its unpadded run")

    # prefill and decode times (CUDA events, warm)
    off = serve_offsets(PROMPT_LENS, SERVE_P)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    pre = []
    for _ in range(3):
        cache = TT.init_cache(cfg, SERVE_B, SERVE_P + n)
        start.record()
        last, cache = prefill_fused(params, cfg, prompts, cache, offsets=off)
        end.record()
        torch.cuda.synchronize()
        pre.append(start.elapsed_time(end))
    step = make_serve_step(cfg)
    tok = last.argmax(-1)[:, None]
    start.record()
    for i in range(n - 1):
        tok, cache = step(params, cache, tok, SERVE_P + i, offsets=off)
    end.record()
    torch.cuda.synchronize()
    dec = start.elapsed_time(end) / (n - 1)
    prefill_ms = sorted(pre)[1]
    log(f"  prefill {prefill_ms:.2f} ms (runs {[round(t, 2) for t in pre]}) "
        f"for {SERVE_B}x{SERVE_P} tokens; decode {dec:.3f} ms a step "
        f"({SERVE_B / dec * 1e3:.1f} tokens/s at B={SERVE_B})")

    # where the time goes: one profiled decode step and one prefill
    breakdown = {}
    for label, fn in (
            ("decode step", lambda: step(params, cache, tok,
                                         SERVE_P + n - 2, offsets=off)),
            ("prefill", lambda: prefill_fused(
                params, cfg, prompts,
                TT.init_cache(cfg, SERVE_B, SERVE_P + n), offsets=off))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        busy, kernels = profile_device_ms(fn, reps=1)
        fam = {}
        for t, _, name in kernels:
            fam[family(name)] = fam.get(family(name), 0.0) + t
        busy = busy or 0.0
        breakdown[label] = {"host_ms": host_ms, "busy_ms": busy,
                            "families": fam}
        log(f"  profile {label}: device ms by family "
            f"{ {k: round(v, 3) for k, v in sorted(fam.items())} }; busy "
            f"{busy:.3f} ms of a {host_ms:.3f} ms call (idle share "
            f"{1 - busy / host_ms:.3f})")
        for t, count, name in sorted(kernels, reverse=True)[:8]:
            log(f"    {t:9.3f} ms  x{count:<4d} {name[:80]}")
    del params, cache
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall * 1e3,
            "prefill_ms": prefill_ms, "decode_ms": dec, "peak_gib": peak,
            "breakdown": breakdown}


def phase_serve_cuda_vs_cpu():
    """Reduced qwen3 in f32, the same parameters on the card (kernels) and
    the CPU (plain versions): greedy tokens equal, prefill logits within
    TOL."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate
    cfg = dataclasses.replace(get_config(SERVE_ARCH + "-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(3, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    P, lens = 40, (40, 23, 9, 1)
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (len(lens), P), generator=g)
    outs, logits = {}, {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        outs[dev] = generate(p, cfg, prompts, max_new_tokens=8,
                             prompt_lens=lens, device=dev).cpu()
        cache = TT.init_cache(cfg, len(lens), P + 1, device=dev)
        off = torch.tensor([P - L for L in lens], device=dev,
                           dtype=torch.int32)
        lg, _ = TT.prefill_forward(p, cfg, prompts.to(dev), cache,
                                   offsets=off)
        logits[dev] = lg.cpu()
    log(f"serve cuda vs cpu: {cfg.name} f32, B={len(lens)} P={P} ragged "
        f"{lens}, 8 new tokens")
    err = check_close("prefill logits", logits["cuda"], logits["cpu"], TOL)
    same = torch.equal(outs["cuda"], outs["cpu"])
    log(f"  greedy tokens {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("greedy tokens differ between cuda and cpu")
    return err


def serving_rows(kern, serve):
    """One JSON row per serving kernel, totalled over one generate: each
    kernel's per-call device times at the run's shapes times its calls; the
    bound from the total bytes and operations of those calls."""
    from repro_torch.configs import get_config
    L, steps = get_config(SERVE_ARCH).n_layers, SERVE_NEW - 1
    rows = []
    for name, (src, replaces) in SERVE_KERNELS.items():
        k = kern[name]
        if name in ("rmsnorm_residual", "swiglu"):
            parts = [(k[SERVE_B * SERVE_P], L), (k[SERVE_B], L * steps)]
        elif name == "flash_attention":
            parts = [(k[SERVE_P], L)]
        else:   # mean of the first and last decode positions, every step
            parts = [(k[SERVE_P], L * steps / 2),
                     (k[SERVE_P + SERVE_NEW - 2], L * steps / 2)]
        tot = {f: sum(r[f] * c for r, c in parts) for f in ("ms", "plain_ms")}
        nbytes = sum(r["work"][0] * c for r, c in parts)
        flops = sum(r["work"][1] * c for r, c in parts)
        bms, by = bound(nbytes, flops, parts[0][0]["work"][2])
        lib = [r["library_ms"] for r, _ in parts]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": serve["launches"][name],
            "max_abs_err": k["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": (None if None in lib else
                           sum(r["library_ms"] * c for r, c in parts))})
    return rows


def gbn_rows(rows, launches, errs):
    """One JSON row per GBN kernel, per ResNet44 step: the 43 GBN calls at
    their three shapes."""
    kernels = []
    for name, pre in (("gbn_forward", "fwd"), ("gbn_backward", "bwd")):
        tot = {k: sum(rows[s][f"{pre}_{k}"] * n for s, n in RESNET_SHAPES)
               for k in ("ms", "plain_ms", "library_ms")}
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
    return kernels


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
        t_start = time.perf_counter()
        phase_build()
        # slice 1: the GBN training path
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
        # slice 2: qwen3-1.7b serving
        kern = phase_serving_kernels()
        serve = phase_serve()
        phase_serve_cuda_vs_cpu()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = gbn_rows(rows, launches, errs) + serving_rows(kern, serve)
    log(f"resnet44 step (B={BATCH}): median warm step {step_ms:.2f} ms; "
        f"GBN kernels {kernels[0]['ms'] + kernels[1]['ms']:.3f} ms a step "
        f"(bound {kernels[0]['bound_ms'] + kernels[1]['bound_ms']:.3f} ms)")
    log(f"serve {SERVE_ARCH} (B={SERVE_B}, P={SERVE_P} ragged, {SERVE_NEW} "
        f"new tokens): generate {serve['wall_ms']:.1f} ms, prefill "
        f"{serve['prefill_ms']:.2f} ms, decode {serve['decode_ms']:.3f} ms "
        f"a step, {SERVE_B * SERVE_NEW / serve['wall_ms'] * 1e3:.1f} new "
        f"tokens/s, peak {serve['peak_gib']:.2f} GiB; serving kernels per "
        f"generate " + ", ".join(f"{r['name']} {r['ms']:.2f} ms (bound "
                                 f"{r['bound_ms']:.3f})" for r in kernels[2:]))
    log(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s after start-up")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
