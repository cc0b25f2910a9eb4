#!/usr/bin/env python3
"""What makes a batched row of the memory path (encoder, cross-attention)
equal its run alone, on one NVIDIA GPU: for each op, the number of output
values of row ``--row`` computed in a batch of 8 that differ from the same
row computed alone, and the largest difference.

    python3 scripts/memory_invariance.py [--arch seamless-m4t-large-v2]

Draws the configuration at full width in bf16 from seed 0 (as
``chip_smoke.py`` does), its stub memory input (0.1 * normal) and the
prompts of ``chip_smoke.py``'s serving phases, then compares, row alone
against the batch: the encoder's output (seamless), each cuBLAS product of
the first encoder layer, the cross K/V projection of the memory, the
plain cross-attention (``layers._sdpa``) of a decode step and of the
prefill's last query row, a decoder layer's wq, wo and w_down at a decode
step (B rows against 1) and in the prefill (B x P rows against the row's
unpadded prompt), plain and through ``layers.rows_matmul``, and the LM
head; then the greedy tokens of the
row's ``generate`` alone with its own memory and with the batched
memory's row, and the top-2 logit gap where a run parts from the batch.
Prints one line an op and a JSON line last, beside the card's name and
power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, NEW = 8, 32


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    ap.add_argument("--row", type=int, default=B - 1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as TB
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    params = TT.init_params(0, cfg)
    if cfg.encoder is not None:
        P, lens, n_mem, width = 128, (128, 112, 96, 80, 64, 48, 32, 16), \
            512, cfg.encoder.d_model
    else:
        P, lens, n_mem, width = 512, (512, 448, 384, 320, 256, 192, 128,
                                      64), cfg.vision.n_image_tokens, \
            cfg.d_model
    g = torch.Generator().manual_seed(1)
    full = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    real = torch.arange(P)[None] >= P - torch.tensor(lens)[:, None]
    prompts = torch.where(real, full, 0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = (0.1 * torch.randn(B, n_mem, width, generator=gen,
                                device=dev)).bfloat16()
    r = args.row
    out = {}

    def compare(name, batched, alone):
        diff = (batched.float() - alone.float()).abs()
        n = int((batched != alone).sum())
        out[name] = {"differ": n, "of": batched.numel(),
                     "max_abs": float(diff.max())}
        print(f"{name:<48} {n} of {batched.numel()} differ, max "
              f"{float(diff.max()):.3e}", flush=True)

    with torch.no_grad():
        def memory_of(x):
            return TT.encode(params, cfg, x, use_kernels=True) \
                if cfg.encoder is not None else x

        memory = memory_of(inputs)
        alone = memory_of(inputs[r:r + 1])
        if cfg.encoder is not None:
            compare("encoder output", memory[r:r + 1], alone)
            lay = params["encoder"]["stack"]["body"][0][0]
            x = inputs
            for w in ("wq", "wk", "wv"):
                compare(f"encoder layer 0 {w} (cuBLAS, M = B x F)",
                        (x @ lay["mixer"][w])[r:r + 1],
                        x[r:r + 1] @ lay["mixer"][w])
            q, k, v = L._project_qkv(
                lay["mixer"], TT.encoder_config(cfg), x,
                torch.arange(n_mem, device=dev)[None].expand(B, n_mem))
            compare("encoder layer 0 _sdpa (non-causal)",
                    L._sdpa(q, k, v, None)[r:r + 1],
                    L._sdpa(q[r:r + 1], k[r:r + 1], v[r:r + 1], None))
            h = torch.randn(B, n_mem, cfg.encoder.d_ff, generator=gen,
                            device=dev).bfloat16()
            compare("encoder layer 0 w_down (cuBLAS)",
                    (h @ lay["ff"]["w_down"])[r:r + 1],
                    h[r:r + 1] @ lay["ff"]["w_down"])
        cross = next(p for s, p in TB.each_layer(params["stack"], cfg)
                     if s.cross_attn)["cross"]
        k, v = L.cross_kv(cross, cfg, memory)
        k1, v1 = L.cross_kv(cross, cfg, memory[r:r + 1])
        compare("cross_kv K (cuBLAS, M = B x S)", k[r:r + 1], k1)
        xq = torch.randn(B, 1, cfg.d_model, generator=gen,
                         device=dev).bfloat16()
        compare("cross-attention, decode (B rows)",
                L.cross_attention_apply(cross, cfg, xq, k, v)[r:r + 1],
                L.cross_attention_apply(cross, cfg, xq[r:r + 1], k[r:r + 1],
                                        v[r:r + 1]))
        xp = torch.randn(B, P, cfg.d_model, generator=gen,
                         device=dev).bfloat16()
        Lr = lens[r]
        compare("cross-attention, prefill (last query row)",
                L.cross_attention_apply(cross, cfg, xp, k, v)[r:r + 1, -1:],
                L.cross_attention_apply(cross, cfg, xp[r:r + 1, P - Lr:],
                                        k[r:r + 1], v[r:r + 1])[:, -1:])
        lay = next(p for s, p in TB.each_layer(params["stack"], cfg)
                   if s.cross_attn)
        Lr = lens[r]
        hd = torch.randn(B, P, cfg.d_ff, generator=gen,
                         device=dev).bfloat16()
        for w, x, K in (("wq", xp, cfg.d_model), ("wo", xp, cfg.d_model),
                        ("w_down", hd, cfg.d_ff)):
            W = lay["ff" if w == "w_down" else "mixer"][w]
            x = x[..., :W.shape[0]]
            for label, fn in (("x @ w", lambda a: a @ W),
                              ("rows_matmul", lambda a: L.rows_matmul(a, W))):
                compare(f"decoder {w} (K={K}) decode {label}",
                        fn(x[:, -1:])[r:r + 1], fn(x[r:r + 1, -1:]))
                compare(f"decoder {w} (K={K}) prefill {label}",
                        fn(x)[r:r + 1, -Lr:], fn(x[r:r + 1, P - Lr:]))
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        compare("LM head (cuBLAS, M = B)", (xq[:, 0] @ head.T)[r:r + 1],
                xq[r:r + 1, 0] @ head.T)

    batch = generate(params, cfg, prompts, memory=memory, prompt_lens=lens,
                     max_new_tokens=NEW)[r, P:].tolist()
    Lr = lens[r]
    for label, mem in (("own memory", alone),
                       ("the batch's memory row", memory[r:r + 1])):
        solo = generate(params, cfg, prompts[r:r + 1, P - Lr:], memory=mem,
                        max_new_tokens=NEW)[0, Lr:].tolist()
        d = next((i for i, (a, b) in enumerate(zip(solo, batch)) if a != b),
                 None)
        gap = None
        if d is not None:
            # the solo run's logits at its first differing token
            toks = torch.tensor([solo[:d]], device=dev).long()
            seq = torch.cat([prompts[r:r + 1, P - Lr:], toks], dim=1)
            cache = TT.init_cache(cfg, 1, seq.shape[1] + 1,
                                  memory_len=mem.shape[1])
            TT.build_cross_cache(params, cfg, mem, cache)
            lg, _ = TT.prefill_forward(params, cfg, seq, cache)
            top = torch.topk(lg[0, -1, :cfg.vocab_size].float(), 2).values
            gap = float(top[0] - top[1])
        out[f"generate alone, {label}"] = {"first_difference": d,
                                           "top2_gap": gap}
        print(f"generate row {r} alone with {label}: "
              f"{'equal' if d is None else f'parts at token {d}'}"
              f"{'' if gap is None else f', top-2 gap {gap:.4g}'}",
              flush=True)
    print(smi())
    print(json.dumps({"arch": args.arch, "row": r, "ops": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
