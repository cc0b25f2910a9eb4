"""Serving launcher (the port of ``repro.launch.serve``): batched generation
against a (reduced or full) architecture.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-1.7b-reduced --batch 8 --prompt-len 16 --max-new 32 \
        [--use-kernels] [--temperature 0.8 --top-k 40] \
        [--prompt-lens 5,16,9,...] [--device cpu]

Reports cold (the first call, the kernels' builds included: "compile")
and warm tok/s; ``--use-kernels`` routes prefill through the
flash-attention kernel and decode through the flash-decode kernel over a
head-major cache. Runs on the card unless ``--device cpu`` (where the
kernels' plain versions run).

``--continuous`` instead drives the continuous-batching engine
(:class:`repro_torch.serving.ContinuousEngine`) under a synthetic Poisson
arrival trace (``--rate`` requests per decode step, ``--requests`` total)
with a paged KV cache (``--page-size``, ``--slots``), and reports sustained
useful AND raw tok/s (raw counts dead retired-lane decodes; the gap is the
engine's dropped work) plus the static lockstep baseline over the same
trace at equal cache memory.

Observability: ``--trace out.json`` writes a Chrome/Perfetto-loadable span
trace of the serving loop, ``--metrics-out out.jsonl`` the metrics registry
(for ``--continuous`` that includes the SLO set: TTFT/ITL/e2e percentiles,
queue depth, slot occupancy, page-pool utilization), and
``--device-trace LOGDIR`` captures a ``torch.profiler`` trace
(:class:`repro_torch.obs.trace.device_trace`) whose kernels line up under
the host spans.

Random draws come from explicit ``torch.Generator`` s seeded from
``--seed`` (the reference's ``jax.random`` keys give other values).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import NULL_TRACER, Observability
from repro_torch.obs.trace import device_trace
from repro_torch.serving import (ContinuousEngine, generate, poisson_trace,
                                 run_static_trace)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _write_obs(args, obs=None) -> None:
    if obs is None:
        return
    obs.write(args.trace, args.metrics_out)
    if args.trace:
        print(f"wrote span trace -> {args.trace} "
              "(load in ui.perfetto.dev or chrome://tracing)")
    if args.metrics_out:
        print(f"wrote metrics JSONL -> {args.metrics_out}")
    table = obs.summary()
    if table:
        print(table)


def _run_continuous(params, cfg, args, dev, *, obs=None) -> None:
    max_len = args.max_len or 4 * args.prompt_len
    max_len = -(-max_len // args.page_size) * args.page_size
    reqs = poisson_trace(
        cfg, args.requests, rate=args.rate, seed=args.seed,
        prompt_len_choices=(args.prompt_len // 2, args.prompt_len),
        new_token_choices=(args.max_new // 2, args.max_new))
    n_blocks = max_len // args.page_size
    eng = ContinuousEngine(
        params, cfg, num_slots=args.slots, max_len=max_len, layout="paged",
        page_size=args.page_size, total_pages=1 + args.slots * n_blocks,
        use_kernels=args.use_kernels, eos_id=args.eos_id,
        temperature=args.temperature, top_k=args.top_k,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        obs=obs, device=dev)
    eng.run(reqs)                      # warm: kernel builds, first launches
    if obs is not None:
        obs.clear()                    # drop warmup spans/latencies
    _sync(dev)
    t0 = time.time()
    comps = eng.run(reqs)
    _sync(dev)
    useful = sum(len(c.tokens) for c in comps.values())
    cont = time.time() - t0
    stats = eng.stats()
    # static lockstep baseline: same trace, equal cache memory (slots x
    # max_len contiguous rows == the paged pool above)
    run_static_trace(params, cfg, reqs, batch=args.slots, max_len=max_len,
                     use_kernels=args.use_kernels, device=dev)   # warm
    _sync(dev)
    t0 = time.time()
    static_useful = run_static_trace(params, cfg, reqs, batch=args.slots,
                                     max_len=max_len,
                                     use_kernels=args.use_kernels,
                                     device=dev)
    _sync(dev)
    stat = time.time() - t0
    print(f"continuous: {useful} useful tok in {cont:.2f}s "
          f"({useful / cont:.1f} useful tok/s, "
          f"{stats['raw_tok_s']:.1f} raw tok/s, "
          f"{int(stats['dropped_tokens'])} dropped, "
          f"{eng.steps} decode steps)")
    print(f"static:     {static_useful} tok in {stat:.2f}s "
          f"({static_useful / stat:.1f} tok/s)")


def _prompts(cfg, args, dev):
    """(prompts (batch, prompt_len), prompt_lens or None): uniform ids
    from ``--seed + 1``; with ``--prompt-lens`` each row left-padded with
    id 0."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    if not args.prompt_lens:
        return prompts, None
    lens = [int(x) for x in args.prompt_lens.split(",")]
    if (len(lens) != args.batch or max(lens) > args.prompt_len
            or min(lens) < 1):
        raise SystemExit("--prompt-lens needs --batch entries, each in "
                         "[1, --prompt-len]")
    prompt_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    col = torch.arange(args.prompt_len, device=dev)[None]
    prompts = torch.where(col >= args.prompt_len - prompt_lens[:, None],
                          prompts, 0)
    return prompts, prompt_lens


def _memory(params, cfg, args, dev):
    """The cross blocks' memory: stub image embeddings for a vision
    config, the encoder over stub frames for an encoder-decoder one (both
    0.1 x normal draws from ``--seed + 2``), else None."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    dt = T.compute_dtype(cfg)
    if cfg.vision is not None:
        return 0.1 * torch.randn(
            (args.batch, cfg.vision.n_image_tokens, cfg.d_model),
            generator=gen, device=dev).to(dt)
    if cfg.encoder is not None:
        frames = 0.1 * torch.randn((args.batch, 32, cfg.encoder.d_model),
                                   generator=gen, device=dev)
        return T.encode(params, cfg, frames.to(dt),
                        use_kernels=args.use_kernels)
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-reduced")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--use-kernels", action="store_true",
                    help="flash-attention prefill + flash-decode kernels")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples logits/temperature")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits (0 = all)")
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated per-sequence prompt lengths "
                         "(<= --prompt-len); prompts are left-padded ragged")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine under a Poisson trace "
                         "(paged KV cache) vs the static baseline")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="--continuous: arrivals per decode step")
    ap.add_argument("--requests", type=int, default=16,
                    help="--continuous: total requests in the trace")
    ap.add_argument("--slots", type=int, default=4,
                    help="--continuous: decode slots (= static batch)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="--continuous: KV cache page size (slots/page)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="--continuous: cache depth (0 = 4x prompt-len)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="--continuous: retire rows on this token id")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto span trace JSON here")
    ap.add_argument("--metrics-out", default="",
                    help="append the metrics registry as JSONL here")
    ap.add_argument("--device-trace", default="",
                    help="torch.profiler trace logdir (device activity "
                         "aligned under the host spans)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    obs = None
    if args.trace or args.metrics_out or args.device_trace:
        obs = Observability(annotate_device=bool(args.device_trace))
    cfg = dataclasses.replace(get_config(args.arch), dtype=args.dtype)
    params = T.init_params(args.seed, cfg, dev)
    if args.continuous:
        ctx = (device_trace(args.device_trace) if args.device_trace
               else contextlib.nullcontext())
        with ctx:
            _run_continuous(params, cfg, args, dev, obs=obs)
        _write_obs(args, obs=obs)
        return
    prompts, prompt_lens = _prompts(cfg, args, dev)
    memory = _memory(params, cfg, args, dev)

    def run():
        gen = (torch.Generator(device=dev).manual_seed(args.seed + 3)
               if args.temperature > 0 else None)
        return generate(params, cfg, prompts, max_new_tokens=args.max_new,
                        memory=memory, use_kernels=args.use_kernels,
                        temperature=args.temperature, top_k=args.top_k,
                        generator=gen, prompt_lens=prompt_lens, device=dev)

    span = (obs.tracer if obs is not None else NULL_TRACER).span
    n_new = args.batch * args.max_new
    ctx = (device_trace(args.device_trace) if args.device_trace
           else contextlib.nullcontext())
    with ctx:
        t0 = time.time()
        with span("serve.generate_cold", batch=args.batch,
                  max_new=args.max_new):
            out = run()
            _sync(dev)
        cold = time.time() - t0
        # explicit warmup: neither the first launches nor queued work of
        # the cold run leak into the warm number
        run()
        _sync(dev)
        t0 = time.time()
        with span("serve.generate_warm", batch=args.batch,
                  max_new=args.max_new):
            out = run()
            _sync(dev)
        warm = time.time() - t0
    if obs is not None:
        obs.registry.observe("serve/generate_warm_s", warm)
        obs.registry.set("serve/generate_warm_tok_s", n_new / warm)
    print(f"generated {tuple(out.shape)} kernels={args.use_kernels} "
          f"temperature={args.temperature}")
    print(f"cold: {cold:.2f}s ({n_new / cold:.1f} tok/s incl. compile)   "
          f"warm: {warm:.2f}s ({n_new / warm:.1f} tok/s)")
    print("sample row:", out[0, :32].tolist())
    _write_obs(args, obs=obs)


if __name__ == "__main__":
    main()
