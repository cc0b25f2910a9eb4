#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits nonzero and prints no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32,
   cuDNN's deterministic algorithms;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   print ptxas's registers and spills, and count the HGMMA (wgmma)
   instructions in the SASS of ``swiglu.cu`` and ``swiglu_bwd.cu`` (none
   fails), and in the SASS of ``flash_decode.cu`` and
   ``flash_decode_paged.cu`` the split-KV body's LDGSTS (16-byte cp.async
   copies), cluster barriers (UCGABAR_ARV, UCGABAR_WAIT) and generic stores
   (ST.E: the stores into rank 0's shared memory; the kernels' global
   stores are STG) (none of one fails), and in the SASS of ``gbn.cu`` the
   persistent GBN body's 1-D bulk copies (UBLKCP; none fails), and in the
   SASS of ``mamba_scan.cu`` the Mamba pair's copies ahead (UTMALDG, TMA
   box loads; none fails);
3. each GBN kernel against its plain PyTorch version on the card (f32) at
   the shapes of the ResNet44/F1 training path (B=4096, ghost 128), at
   ragged shapes and at a ghost over the persistent body's budget (the
   two-pass body), two calls bit-equal, plus a leftover-rows ``gbn_apply``
   with live mu/var cotangents; at the path's shapes, for each shape the
   body and plan, CUDA-event and profiler device ms a call, the kernels a
   call launches (the forward exactly one GBN kernel, the backward at most
   two, and at most a memset besides: no PyTorch arithmetic, else it
   fails), the two-pass body's times beside, and the plain version,
   ``F.batch_norm`` yardstick and byte bound;
4. ``train_vision`` on RESNET44_CIFAR10 at full width, B=4096, the
   LB+LR+GBN+RA recipe, through the CUDA GBN pair (5 steps; the launch
   counters must show 43 forward + 43 backward GBN calls per step), its
   step time, then a short F1_MNIST run at B=4096;
5. one reduced ResNet step on the card (kernels) against the same step on
   the CPU (plain versions) from the same parameters, TF32 off;
6. each serving kernel (rmsnorm_residual, swiglu, flash_attention,
   flash_decode) against its plain version on the card: at the full-width
   qwen3-1.7b shapes of phase 7 in bf16 (BF16_TOL) and at small f32
   shapes (TOL), ring/window decode included, the norm also with no
   residual; flash_attention's bf16 tensor-core body also at the edge
   shapes FLASH_EDGES (T 17/100/130, kv_offsets (0, 37), (0, 7, 129) and
   (64, 0), windows, non-causal, GQA 2:1 to 8:1, hd 32 to 256, kimi-k2's
   112 and h2o-danube's 120; o at BF16_TOL, lse at TOL; the shapes at 112
   and 120 also in f32 at TOL); swiglu's h and g at 4096 rows: two calls
   bit-equal, and INVARIANT_ROWS bit-equal to their solo runs and to an
   8-row call; device times of kernel, plain version and one library
   call, and the bound, at phase 7's shapes (flash_decode's three each call
   on the next of DECODE_CACHES caches, whose visible slots together are
   three times the 50 MB L2, as a generate's layers read theirs from device
   memory, timed in turn for DECODE_ROUNDS rounds, medians; its time on one
   cache over and over, L2-warm, is printed beside them); the split-KV
   decode's edges (``decode_edge_checks``): rows at positions CHUNK - 1,
   CHUNK, CHUNK + 1 and 2 CHUNK against the plain version (f32 and bf16
   caches, with offsets and RoPE, with a window), a cache of S = 544
   against the same contents padded to S = 1024 bit for bit, and the rows
   of batches of 1, 8 and 16 bit-equal to their solo runs, at qwen3-1.7b's
   (16, 8, 128), h2o-danube's (32, 8, 120) and kimi-k2's (64, 8, 112)
   heads and widths (DECODE_EDGE_WIDTHS); the norm at
   every width of NORM_WIDTHS (1024 to 8192) in bf16 at 1, 8 and 4096
   rows, with and without the residual, at (17, 128), (5, 100) and
   (300, 7) in f32 and on unaligned views; at 4096 rows two calls
   bit-equal and NORM_INVARIANT_ROWS bit-equal to their solo calls (y and
   s), and the CUDA-events ms a call at each width beside its bound; the
   (4096, 2048) call also by CUDA events and the (1, 128) call's device
   time (the kernel's fixed cost); every norm timing but the fixed cost
   goes round copies of its inputs past the L2 (``input_copies``);
7. full-width qwen3-1.7b ``generate`` in bf16 (random weights from
   SERVE_SEED): B=8 left-padded prompts of width 512 (PROMPT_LENS),
   greedy, 32 new tokens. The launch counters must show 28
   flash_attention, 868 flash_decode, 1824 rmsnorm_residual (the fused
   residual norm, each layer's pre-attention norm and the final norm, 57
   a forward pass) and 896 swiglu launches; rows 0 and 7 must equal their
   unpadded runs. Prefill ms,
   decode ms a step, tokens/s, peak memory, and a profiled decode step
   and prefill;
8. reduced qwen3 in f32 on the card against the CPU from the same
   parameters: greedy tokens equal, prefill logits within TOL;
9. the paged decode kernel (flash_decode_paged) against its plain version
   on the card: the reference's paged cases in f32 (MHA, GQA, window 24,
   ragged offsets; shuffled block tables; fused RoPE) at TOL, trash-page
   tails and an all-trash row, an int8 pool without and with window or
   RoPE, and the engine's full-width bf16 shape at BF16_TOL; at that shape
   its output must equal flash_decode's on the contiguous cache bit for
   bit; ``decode_edge_checks`` for every pool type (f32, bf16, int8 with f32
   and with bf16 queries; a block table of 34 pages against 64 with the
   trash page past pos; the chunk edges bit-equal to flash_decode on pools
   of q's dtype) at the three DECODE_EDGE_WIDTHS (an int8 row of 120 is
   120 bytes: 8-byte copies), the reference's cases also at 112 and 120 in
   f32. Device times a call of kernel (bf16 and int8 pools),
   plain version and one library call (``kp[pt]`` gather + SDPA) at four
   states sampled across phase 10's run, on pools that do not fit in L2,
   timed in turn for three rounds;
10. ContinuousEngine on qwen3-1.7b in bf16 at full width, the depth cut
   to ENGINE_LAYERS = 8 of 28 layers (the first 8 layers of phase 7's
   weights): 16 slots, max_len 1024, a paged pool of 1025 pages of 16,
   greedy, the 32-request Poisson trace ENGINE_TRACE. Every request must
   complete; the launch counters must show 8 flash_decode_paged launches
   a step, no flash_decode launch in a decode step and 8 flash_attention
   launches an admission; four requests (the first admitted, one admitted
   into a recycled slot, one with a 512-token prompt, the last admitted)
   must equal their solo ``generate`` runs. The same trace on an int8 pool
   (pool bytes, token agreement with bf16); both pools run again in the
   other order (stats of each read twice), then once each under the
   profiler (device ms and launches by kernel family over the whole run,
   the paged kernel's count checked against the counter; a run whose
   profile lost a paged kernel event is profiled once more), and one
   profiled decode step of each; peak memory; the same trace through
   ``run_static_trace`` (the lockstep baseline, batch 16);
11. reduced qwen3 in f32 through ContinuousEngine on the card (kernels)
   and the CPU (plain versions), full-precision and int8 pools: equal
   completions;
12. each training kernel (rmsnorm_residual_backward, swiglu_backward,
   flash_attention_rope, flash_attention_backward) against its plain
   version on the card: at the full-width qwen3-1.7b shapes of phase 13
   in bf16 (BF16_TOL) and at small f32 shapes (the reference tests'
   tolerances), with ragged T, a window, GQA and the norm without a
   residual; the bf16 tensor-core bodies of B7 and B8 also at FLASH_EDGES
   (the backward to hd 128; at hd 112 and 120 in f32 too, and the plain
   f32 backward at both); the RoPE backward (one launch on the
   unrotated q, k) against the composite plain version in bf16 and f32;
   two B8 calls on the same inputs give equal bits; swiglu_backward's dx,
   dg and du at 4096 rows as swiglu's in phase 6 (two calls bit-equal,
   rows bit-equal to their solo and 8-row runs); each autograd
   Function's gradients against plain autograd through the plain forward;
   device times of kernel, plain version and one library call (CUDA
   events), and the bound; the norm backward also at (300, 7) and (64,
   8192) in f32 (the stream body, also timed at 4096 rows) and on
   unaligned views, its (8, 2048) call's device time, and at every width
   as phase 6's forward (dx; dscale relative to its largest entry; two
   calls bit-equal in dx and dscale);
13. full-width qwen3-1.7b training in bf16 (random weights from
   SERVE_SEED, f32 momentum): make_lm_train_step(use_kernels=True) on B=8
   rows of T=512 from token_lm, one warm and five timed steps on the same
   batch. The launch counters of a step must show 57 rmsnorm_residual and
   57 rmsnorm_residual_backward, 28 of each of swiglu, swiglu_backward,
   flash_attention_rope and flash_attention_backward, and no
   flash_attention or decode launch, and no plain-torch RoPE rotation
   (``ref.rope_rotate_hm``) in any step; the loss must be finite
   and fall; a remat=True step from the same state must give the same
   loss and parameters within BF16_TOL. Step ms, tokens/s, peak memory, and one
   profiled step by kernel family, whose kernel counts must match the
   counters;
14. reduced qwen3 in f32: one train step on the card (kernels) against
   the same step on the CPU (plain versions) from the same parameters:
   loss within LOSS_TOL, parameters within TOL;
15. the Mamba chunk-scan kernels (mamba_chunk, B10; mamba_chunk_backward,
   B11) against their plain versions on the card: the reference tests'
   shapes, a ragged chunk, a d_inner of 100, d_state 5, a 2048-step chunk
   (the backward's checkpoints in its device scratch), the full-width
   (8, 256, 8192, 16) of phases 16 and 17 and a solo row of it, f32 at TOL
   and bf16 inputs at BF16_TOL, a non-zero h0 and live cotangents on both
   outputs; each shape's plans; two calls of each kernel bit-equal, dt = 0
   steps pass the state bit for bit, two chained chunks equal one scan, the
   autograd Function's gradients equal plain autograd; at the full-width
   shape and its solo row, each wrapper's plan, CUDA-event and profiler
   device ms a call and the kernels a call launches, from
   ``scripts/mamba_times.py`` in a process of its own (B10 exactly one, B11
   exactly two and the dA sum, else it fails) beside the baseline of the
   first kernels (MAMBA_BASELINE); times (CUDA events) of the plain version
   and the bound (bytes, or one exp a (t, channel, state) at the SFU rate);
16. full-width falcon-mamba-7b ``generate`` in bf16 (64 layers, random
   weights from SERVE_SEED), the prompts of phase 7: exactly 128
   mamba_chunk launches (two chunks a layer, none in decode) and 65
   rmsnorm_residual launches a forward pass, nothing else; rows 0 and 7
   equal to their unpadded runs (else the top-2 logit gap where they part);
   prefill ms, decode ms a step, tokens/s, peak memory, a profiled prefill
   and decode step;
17. falcon-mamba-7b training at full width, depth cut to 16 layers (bf16,
   f32 momentum, B=8 x T=512 of token_lm, lr and clip as phase 13; one warm
   and five timed steps): exactly 32/32 mamba launches and 17/17 norm
   launches a step, the loss falling, a remat step equal to the plain one,
   step ms, tokens/s, peak memory, a profiled step whose kernel counts
   match the counters;
18. reduced falcon-mamba in f32, card (kernels) against CPU (plain
   versions): ragged greedy tokens equal, prefill logits within TOL, one
   train step's loss within LOSS_TOL and parameters within TOL;
19. the paper's sweeps (slice 6): ``generalization_gap(steps=48,
   large_batch=4096, small_batch=128, ghost=128)`` on RESNET44_CIFAR10 at
   full width with ``use_kernels=True`` and SWEEP_DATA, evaluating every 16
   steps, through ``run_sweep(checkpoint_every=16)`` under an ``obs`` whose
   spans read the launch counters: five records, their Table-1 view, and
   each run's wall_s, steps and median ms a step. B1 and B2 must launch
   exactly 43 + 43 a step in the two +GBN columns and none in the other
   three, none in an evaluation and none outside the steps; each record's
   steps must be its regime's and every accuracy finite. The
   LB+LR+GBN+RA run killed at its step-16 evaluation and run again from
   its checkpoint must give a record equal to the sweep's in every field
   but ``wall_s``; the sweep run again must skip all five runs and run no
   step; then the step time and a profiled step of SB (B=128) and LB
   (B=4096), as in phase 4;
20. ``lm_smoke(steps=8)`` through the runner for reduced qwen3-1.7b and
   falcon-mamba-7b in f32 (``use_kernels=True``, two methods each,
   checkpoints every 4 steps): every step must launch exactly the train
   step's kernels, every evaluation the forward ones once per holdout
   chunk; the qwen3 LB+LR+NOISE run killed at its step-4 evaluation and
   resumed must equal its record but for ``wall_s``;
21. full-width qwen2-moe-a2.7b ``generate`` in bf16 (24 layers, 60
   experts top-4 and a fused shared expert, random weights from
   SERVE_SEED), the prompts of phase 7: exactly 24 flash_attention, 744
   flash_decode, 1568 rmsnorm_residual (49 a pass) and 768 swiglu (the
   shared expert) launches, nothing else; a second run bit-equal; the
   shares of dropped assignments at prefill and decode; prefill ms,
   decode ms a step, tokens/s, peak memory, a profiled prefill and decode
   step by family (the routed experts' ``bmm``, the dispatch's and
   combine's index copies and the routing named by the op that launched
   them inside the MoE layer, MOE_OPS and MOE_SCOPES), and a profiled
   generate: device ms by family;
22. ContinuousEngine on the same parameters: phase 10's slots, max_len
   and pages, a bf16 pool, the first MOE_ENGINE_REQUESTS requests of
   ENGINE_TRACE; every request completes; exactly 24 flash_decode_paged
   launches a step and 24 flash_attention launches an admission, 49
   rmsnorm_residual and 24 swiglu a pass; useful tokens/s; a profiled run
   (the paged kernel's device ms, its count against the counter);
23. qwen2-moe-a2.7b training at full width, depth cut from 24 to
   MOE_TRAIN_LAYERS = 2 (bf16, f32 momentum, B=8 x T=512, lr and clip as
   phase 13; one warm and five timed steps): exactly 5/5 norm, 2/2
   SwiGLU and 2/2 RoPE flash attention launches a step, the loss
   falling, a remat step equal to the plain one, step ms, tokens/s, peak
   memory, moe_aux, a profiled step whose kernel counts match the
   counters;
24. reduced qwen2-moe-a2.7b and kimi-k2-1t-a32b in f32, and the reduced
   kimi-k2 with kimi-k2's head width of 112, card (kernels)
   against CPU (the plain model path, ``use_kernels=False``) from the same
   parameters: the ragged prefill's routing equal layer by layer, left
   pads included (topi, then slot, keep and the capacity;
   a token routed differently fails unless two of its k + 1 largest
   probabilities are within NEAR_TIE, and such tokens are counted),
   prefill logits within TOL, greedy tokens of ragged prompts equal, one
   train step's loss within LOSS_TOL and parameters within TOL;
25. full-width seamless-m4t-large-v2 in bf16 (24 decoder layers, each with
   a cross block, and a 24-layer non-causal encoder; random weights from
   SERVE_SEED): ``encode`` of ENCDEC_FRAMES = 512 stub frames (0.1 *
   normal), then ``generate(memory=)`` of B=8 prompts left-padded to 128
   (ENCDEC_LENS), 32 greedy tokens: exactly 49 rmsnorm_residual and 24
   swiglu launches in the encoder, and 24 flash_attention, 744
   flash_decode, 2336 rmsnorm_residual (73 a pass: norm_x, the
   pre-attention and the fused residual norm of each layer, the final
   norm) and 768 swiglu in the generate, nothing else (the encoder's
   attention and the cross-attentions are plain, as in the reference); a
   second run's memory and tokens bit-equal; rows 0 and 7 equal to their
   runs alone (their own frames encoded alone; the prompt left-padded by
   its pad modulo KEY_TILE = 64, as B9 and B12 tile keys from slot 0: row
   7's pad of 112 by 48, and also unpadded, printed); encoder ms,
   prefill ms (cross cache and fused prefill), decode ms a step, peak
   memory, and profiled runs by family (``encode`` and ``cross_attention``
   name the cuBLAS and other kernels launched inside them);
26. seamless training at full width and depth (B=8 x T=512 of token_lm
   and 128 stub frames, lr and clip as phase 13; one warm and five timed
   steps): exactly 122/122 norm, 48/48 SwiGLU and 24/24 RoPE flash
   attention launches a step (encoder and decoder), the loss falling, a
   remat step equal to the plain one, step ms, tokens/s, peak memory, a
   profiled step whose kernel counts match the counters;
27. full-width llama-3.2-vision-11b in bf16 (40 layers, 8 with a cross
   block into 1600 stub image embeddings): ``generate(memory=)`` with the
   prompts of phase 7, as phase 25: exactly 40 flash_attention, 1240
   flash_decode, 2848 rmsnorm_residual (89 a pass) and 1280 swiglu
   launches; bit-equal repeats; rows 0 and 7 equal to their runs alone;
28. llama-vision training at full width, the depth cut from 40 to
   VLM_TRAIN_LAYERS = 10 (2 of 8 periods, 2 cross blocks; at 40 layers f32
   momentum alone is ~40 GB beside 20 GB of weights and 20 GB of
   gradients), as phase 26: 23/23 norm, 10/10 SwiGLU and 10/10 RoPE flash
   attention launches a step;
29. jamba-v0.1-52b in bf16 at full width, the depth cut from 32 to
   JAMBA_LAYERS = 16 (2 of 4 periods: ~26 B parameters, ~52 GB; 14 Mamba
   and 2 attention layers, 8 MoE and 8 dense feed-forwards; 32 layers
   would be ~102 GB): ``generate`` with the prompts of phase 7: exactly 2
   flash_attention, 62 flash_decode, 28 mamba_chunk, 1056
   rmsnorm_residual and 256 swiglu launches, nothing else; a second run
   bit-equal; the dropped shares; prefill ms, decode ms a step, peak
   memory, profiled runs by family (the MoE layer's ops as phase 21's).
   Then ContinuousEngine on the first MOE_ENGINE_REQUESTS requests of
   ENGINE_TRACE (phase 10's slots, max_len and pages): the attention
   layers' pages and the Mamba layers' states in one engine; every request
   completes with exact launches (2 flash_decode_paged a step, 2
   flash_attention and a mamba_chunk a 256 prompt tokens a Mamba layer an
   admission); useful tokens/s and a profiled run. Its batched rows are
   held to the CPU (phase 30) and to exact launches, not to solo runs: MoE
   decode capacity pools over the batch;
30. the six new configurations reduced (seamless, llama-vision, jamba,
   phi3-medium-14b, gemma3-27b, h2o-danube-3-4b) in f32, card (kernels)
   against CPU (the plain model path) from the same parameters and
   memory input: jamba's prefill routing equal layer by layer first,
   prefill logits within TOL, greedy tokens of ragged prompts equal (past
   gemma3's window), one train step's loss within LOSS_TOL and parameters
   within TOL;
31. the parallel layer (slice 9), its ranks processes spawned with
   ``torch.multiprocessing`` that all compute on the one card (device 0)
   and talk over gloo through a ``file://`` store (NCCL refuses two ranks
   on a GPU): data-parallel ResNet44 at published width over 2 ranks,
   global B=4096 (2048 a rank, ghosts of 128, LB+LR+GBN+RA), 1 warm and
   MESH_DP_STEPS timed steps: exactly 43 + 43 GBN launches a step on each
   rank, the ranks' parameters bit-identical after every step (and
   ``dp_gbn_forward`` through B1: both ranks' per-ghost statistics
   gathered rank-major, each rank's own against ``gbn_ref``), against
   the single-process card step from the same parameters on the same
   global batch the first three losses within LOSS_TOL and the parameters
   after three steps within TOL, and the running statistics after steps 1
   and 2 the mean of the single-process states over each rank's shard;
   step ms, the all-reduce's ms and bytes a step, peak memory a rank, a
   profiled step a rank;
32. qwen3-1.7b at published widths cut to MESH_LM_LAYERS = 8 layers over
   4 ranks as (2 data, 2 model) with ``tp=True, fsdp=True``, bf16, SGD,
   B=8 x 512 globally, 1 warm and MESH_LM_STEPS timed steps: exactly
   17/17 norm, 8/8 SwiGLU and 8/8 RoPE flash attention launches a step on
   every rank (a rank's TP slice, 8 of 16 q heads, 4 of 8 kv heads, d_ff
   3072, through the same kernels), the loss falling, the leaves kept
   whole over "model" bit-identical across each model group; step ms,
   collective ms and bytes (the FSDP gathers move each large leaf whole),
   peak memory beside ``state_bytes_per_device``;
33. qwen2-moe-a2.7b at published widths cut to MESH_EP_LAYERS = 2 layers
   over the same mesh, 30 of 60 experts a rank (and FSDP over "data", so
   that four ranks' states fit the card), B=4 x 512 globally, 1 warm and
   MESH_EP_STEPS timed steps: exact launches, the loss
   falling, the first MoE layer's dropped assignments equal to the
   single-process card forward's (a later layer's share within
   DROP_TOL); step ms and expert bytes a rank;
34. reduced f32, card against card, within TOL: dp, tp, fsdp, tp+fsdp
   with SGD and Adam and EP over 4 ranks against the single-process
   step; int8 momentum (card against CPU); a 2-step generalization-gap
   sweep with ``use_mesh=True`` over 2 ranks against the single-process
   sweep; a sharded checkpoint of the 4 ranks restored in one process;
35. model-sharded serving: ContinuousEngine(mesh=) over 2 ranks as (1
   data, 2 model) that share the card, phase 10's model (qwen3-1.7b at
   full width cut to ENGINE_LAYERS = 8 of 28 layers, phase 7's weights),
   ENGINE_TRACE, 16 slots, pages of 16, a bf16 and an int8 pool: a rank
   holds 8 of 16 q heads, 4 of 8 kv heads of every pool and d_ff 3072.
   Gates: each request's prefill logits within BF16_TOL of phase 10's
   (relative to their largest magnitude) and its first token equal, or,
   where phase 10's logits are near-tied, trailing phase 10's pick there
   by at most BF16_TOL of the largest magnitude (random weights leave
   such ties, which bf16 partial sums flip); each rank's launches of B3,
   B5, B9 and B13 equal phase 10's; reduced f32 over the same ranks gives
   the unsharded engine's tokens. Printed:
   the share of bf16 tokens equal to phase 10's, useful tokens/s, decode
   ms a step, the collectives' calls, bytes and ms a step, idle share,
   pool bytes a rank (``steady_steps``: 16 rows active, a profiled step);
36. the launchers as a user runs them: ``python -m
   repro_torch.launch.serve --arch qwen3-1.7b-reduced --use-kernels
   --continuous --device-trace DIR --trace F --metrics-out M`` and a
   5-step ``python -m repro_torch.launch.train``; each exits 0, and the
   device trace holds the B9 kernels under ``serve.admit`` and every B13
   kernel under ``serve.decode_step``;
37. h2o-danube-3-4b at its published widths (d_model 3840, 32/8 heads,
   head width 120, d_ff 10240, window 4096; random bf16 weights from
   SERVE_SEED): B7, B8, B9, B12 and B13 at width 120 against their plain
   versions at this phase's shapes (BF16_TOL), each timed a call (inputs
   from device memory) beside its plain version, SDPA and its bound;
   ``generate`` of phase 7's prompts at all 24 layers (exact launches, rows
   0 and 7 equal to their unpadded runs, prefill and decode ms, a profiled
   generate); ContinuousEngine on phase 10's slots, pages and trace (every
   layer slides, so the engine keeps bf16 rings and decodes through B12, as
   the reference's engine does: an int8 pool would hold no layer; exact
   launches; useful tokens/s); a train step (B=8 x 512, lr
   0.5, clip 1.0, 1 warm + 5 timed, as phase 13) at all 24 layers (its
   depth printed): exact launches, the loss falling, a remat step equal.

A line before the second-to-last gives the MoE path's kernels: each one's
device ms and launches in the profiled generate, engine run and train
step of phases 21–23; the line after it slice 8's (phases 25–29), then
slice 9's (phases 31–33: launches a step on a rank and each rank's device
ms in its profiled step). Times of ranks that share one card are not
scaling numbers. The norm widths line after them gives B3's and B4's
CUDA-events ms a call at 4096 rows of each width of NORM_WIDTHS beside
their bounds, each call's inputs read from device memory
(``input_copies``). Then the h2o-danube-3-4b line (phase 37) and its
kernels at width 120: ms a call beside the bound, plain and library ms,
device ms and kernels in the profiled generate and train step.
The second-to-last line is a JSON object with one entry per kernel (GBN
per ResNet44 step, the static serving kernels per ``generate``, with a
bound that sums the prefill calls' and the decode calls' own bounds; the paged
decode per bf16 engine run: its ms from the profiled run, its plain and
library ms from phase 9's per-call times, its bound from every launch's
positions; the training kernels per train step: ms from the profiled
step, plain and library ms from phase 12's per-call times, taken with
CUDA events; B10 per falcon-mamba generate and B11 per falcon-mamba train
step: phase 15's per-call times and bound at the full-width f32 shape of
every such call times the launches, no library call). The last line is
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4               # as tests/test_kernels.py holds the Pallas kernels
LOSS_TOL = 1e-5          # as the reference's train-step equivalence tests
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
ROTATE_BYTES = 3 * 50 * 2 ** 20   # inputs a timing goes round: 3 x the L2
BATCH, GHOST = 4096, 128
STEPS = 5
# GBN (G, R, C) per ResNet44 layer at B=4096, ghost 128: the stem and the
# 14 convs of stage 1, then 14 in each of stages 2 and 3
RESNET_SHAPES = [((32, 131072, 16), 15), ((32, 32768, 32), 14),
                 ((32, 8192, 64), 14)]
F1_SHAPE = (32, 128, 512)
RAGGED_SHAPES = [(3, 77, 200), (1, 16, 8), (2, 33, 10), (7, 1001, 24)]
TWO_PASS_SHAPE = (2, 2 ** 19, 16)   # a ghost over the persistent budget
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


def check_rows_solo(name: str, fn, args, row_args, rows) -> None:
    """Batch invariance and determinism of a row-wise kernel: ``fn(*args)``
    twice gives equal bits; the outputs at each of ``rows`` equal, bit for
    bit, those of a call on the first 8 rows (for rows below 8) and of a
    call on that row alone. ``row_args``: indices of the arguments that
    hold one entry per row."""
    many = fn(*args)
    if not all(a.equal(b) for a, b in zip(many, fn(*args))):
        raise AssertionError(f"{name}: two calls on the same inputs differ")

    def cut(lo, hi):
        return [a[lo:hi].clone() if k in row_args else a
                for k, a in enumerate(args)]

    eight = fn(*cut(0, 8))
    for i in rows:
        one = fn(*cut(i, i + 1))
        for k, (a, b) in enumerate(zip(many, one)):
            if not a[i:i + 1].equal(b) or (i < 8 and not eight[k][i:i + 1]
                                            .equal(b)):
                raise AssertionError(f"{name}: output {k} of row {i} differs "
                                     f"from its solo run")
    log(f"  {name} ({args[0].shape[0]} rows): two calls bit-equal; rows "
        f"{rows} bit-equal to their solo runs (and to the 8-row call)")


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


def queued_ms(fn, reps: int = 50) -> float:
    """As ``time_ms``, with the calls queued behind a sleep kernel, so the
    device runs them back to back however slowly the host issues them (a
    norm wrapper's host time is tens of microseconds a call, more than its
    kernels' at many shapes)."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)        # ~10 ms at the H100's clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def input_copies(*args):
    """[args] and clones of the tensors ``args``: enough copies to pass
    ROTATE_BYTES, three times the H100's 50 MB L2, so that a call timed on
    them in turn (``rotating``) reads its inputs from device memory, as its
    byte bound counts them, and not from the L2 that the call before left
    warm."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = max(2, min(64, math.ceil(ROTATE_BYTES / nbytes)))
    return [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]


def rotating(fn, inputs):
    """A zero-argument call that runs ``fn`` on the next tuple of
    ``inputs`` in turn. Each tuple's last result is held until its next
    turn, so the outputs go round as many buffers as the inputs. Each
    tuple runs once here, so that the allocator holds every buffer before
    a timing starts (a first pass that allocates inside queued events
    starved the device behind the host)."""
    held = [fn(*args) for args in inputs]
    turn = itertools.cycle(range(len(inputs)))

    def call():
        i = next(turn)
        held[i] = fn(*inputs[i])
    return call


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


# sources whose bf16 bodies must issue wgmma (HGMMA in their SASS)
WGMMA_SOURCES = ("swiglu.cu", "swiglu_bwd.cu")
# the split-KV decode body: 16-byte cp.async copies, the cluster barrier and
# the stores into rank 0's shared memory (generic ST; global stores are STG)
DECODE_SOURCES = ("flash_decode.cu", "flash_decode_paged.cu")
DECODE_SASS = {"LDGSTS": r"LDGSTS\b", "UCGABAR_ARV": r"UCGABAR_ARV\b",
               "UCGABAR_WAIT": r"UCGABAR_WAIT\b", "ST.E": r"\bST\.E\b"}
# the persistent GBN body: 1-D bulk copies (cp.async.bulk) into shared memory
GBN_SASS = {"UBLKCP": r"\bUBLKCP\b"}
# the Mamba pair's inputs copied in ahead: TMA box loads
MAMBA_SASS = {"UTMALDG": r"\bUTMALDG\b"}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {build.SOURCES} with nvcc {' '.join(build.NVCC_FLAGS)} in "
        f"{time.perf_counter() - t0:.1f} s (each nvcc ended after "
        f"{ {s: round(t, 1) for s, t in build.build_seconds.items()} } s)")
    for src, text in build.build_logs.items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_label(line)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {src} {entry}: {line.strip()}")
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    checked = list(WGMMA_SOURCES) + list(DECODE_SOURCES) + ["gbn.cu",
                                                           "mamba_scan.cu"]

    def sass_of(src):
        return subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(src))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    with concurrent.futures.ThreadPoolExecutor() as pool:  # in parallel
        sasses = dict(zip(dict.fromkeys(checked), pool.map(
            sass_of, dict.fromkeys(checked))))
    for src in WGMMA_SOURCES:
        sass = sasses[src]
        n = sum("HGMMA" in line for line in sass.splitlines())
        log(f"  sass {src}: {n} HGMMA instructions")
        if n == 0:
            raise AssertionError(f"{src}: no HGMMA in its SASS")
    for src, ops in [(s, DECODE_SASS) for s in DECODE_SOURCES] + [
            ("gbn.cu", GBN_SASS), ("mamba_scan.cu", MAMBA_SASS)]:
        sass = sasses[src]
        counts = {op: len(re.findall(rx, sass)) for op, rx in ops.items()}
        log(f"  sass {src}: " + ", ".join(f"{n} {op}"
                                          for op, n in counts.items()))
        missing = [op for op, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"{src}: no {missing} in its SASS")


def kernel_label(line: str) -> str:
    """'name<args>' of a kernel from ptxas's 'Compiling entry function'
    line (its mangled name: <file hash><length><name>I<args>E...)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", line)
    if not m:
        return line.split("'")[1][:60] if "'" in line else "?"
    start = m.end()
    name = line[start:start + int(m.group(1))]
    rest = line[start + int(m.group(1)):]
    args = []
    if rest.startswith("I"):
        if rest.startswith("If"):
            args.append("float")
        elif rest.startswith("I13__nv_bfloat16"):
            args.append("bf16")
        args += re.findall(r"L[a-z](\d+)E", rest.split("EEv")[0])
    return f"{name}<{','.join(args)}>"


def gbn_inputs(shape, seed):
    import torch
    G, R, C = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    x = 2.0 * randn(G, R, C) + 0.5
    gamma = torch.linspace(0.5, 1.5, C, device="cuda")
    beta = torch.linspace(-1.0, 1.0, C, device="cuda")
    return x, gamma, beta, (randn(G, R, C), randn(G, C), randn(G, C))


def plan_line(p) -> str:
    if p.body == "two_pass":
        g = p.geometry
        return (f"two_pass (chunks {g.nchunks} x {g.chunk_rows} rows, "
                f"{g.threads} threads, vec {g.vec})")
    return (f"persistent (grid {p.grid} = {p.ngroups} groups x P {p.P}, "
            f"{p.blocks_per_sm} an SM; slices of {p.slice_rows} rows in "
            f"{p.nsub} x {p.sub_rows}; ring {p.nslot} slots, "
            f"{p.smem_bytes} B)")


def gbn_call_times(label, fn, gate=None):
    """CUDA-event and profiler device ms a call of ``fn``, and what one call
    launches on the device. ``gate`` = the most GBN kernels a call may
    launch: any other kernel (PyTorch arithmetic) or a second memset
    fails."""
    events = time_ms(fn)
    for attempt in range(3):
        # a window that lost the GBN kernels' events (as profiler windows
        # on the card now and then do) is profiled again, three at most
        device, kernels = profile_device_ms(fn, reps=10)
        if device is None:
            raise AssertionError(f"{label}: the profiler shows no device "
                                 f"time")
        per_call = {name: n for _, n, name in kernels}
        gbn = sum(n for name, n in per_call.items() if "gbn_" in name)
        memsets = sum(n for name, n in per_call.items() if "memset" in
                      name.lower())
        if gbn >= 1:
            break
        log(f"    {label}: the profiled window lost the GBN kernels' "
            f"events ({per_call}); profiling again")
    other = [name for name in per_call if "gbn_" not in name and
             "memset" not in name.lower()]
    log(f"    {label}: events {events:.4f} ms, device {device:.4f} ms a "
        f"call; {gbn} GBN kernels, {memsets} memsets"
        + (f", other {other}" if other else ""))
    if gate is not None and (other or memsets > 1 or not 1 <= gbn <= gate):
        raise AssertionError(f"{label}: a call launches {per_call}; want 1 "
                             f"to {gate} GBN kernels, at most one memset "
                             f"and nothing else")
    return events, device, gbn + memsets


def phase_kernels(rows):
    """Kernel vs plain at every shape, two calls bit-equal; bodies, plans,
    launches and times at the path's shapes. Fills ``rows[shape] = {...}``
    with the measurements."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gbn as K
    from repro_torch.kernels import ref
    errs = {"gbn_forward": 0.0, "gbn_backward": 0.0}
    timed = [s for s, _ in RESNET_SHAPES] + [F1_SHAPE]
    sms = K.sm_count(torch.cuda.current_device())
    for i, shape in enumerate(timed + RAGGED_SHAPES + [TWO_PASS_SHAPE]):
        G, R, C = shape
        pf, pb = (K.plan(G, R, C, sms, backward=b) for b in (False, True))
        log(f"kernel check {shape} on {sms} SMs\n  forward  {plan_line(pf)}"
            f"\n  backward {plan_line(pb)}")
        want = "two_pass" if shape == TWO_PASS_SHAPE else "persistent"
        if {pf.body, pb.body} != {want}:
            raise AssertionError(f"{shape}: bodies {pf.body}, {pb.body}; "
                                 f"want {want}")
        x, gamma, beta, (dy, dmu, dvar) = gbn_inputs(shape, i)
        y, mu, var = K.gbn_forward(x, gamma, beta)
        yr, mur, varr = ref.gbn_ref(x, gamma, beta)
        torch.cuda.synchronize()
        errs["gbn_forward"] = max(
            errs["gbn_forward"], check_close("forward y", y, yr),
            check_close("forward mu", mu, mur),
            check_close("forward var", var, varr))
        if not all(a.equal(b) for a, b in zip(
                (y, mu, var), K.gbn_forward(x, gamma, beta))):
            raise AssertionError(f"{shape}: two forward calls differ")
        del y, yr
        dx, dg, db = K.gbn_backward(x, gamma, mur, varr, dy, dmu, dvar)
        dxr, dgr, dbr = ref.gbn_backward_ref(x, gamma, mur, varr, dy, dmu,
                                             dvar)
        torch.cuda.synchronize()
        errs["gbn_backward"] = max(
            errs["gbn_backward"], check_close("backward dx", dx, dxr),
            check_sum("backward dgamma", dg, dgr),
            check_sum("backward dbeta", db, dbr))
        if not all(a.equal(b) for a, b in zip(
                (dx, dg, db),
                K.gbn_backward(x, gamma, mur, varr, dy, dmu, dvar))):
            raise AssertionError(f"{shape}: two backward calls differ")
        log("  two calls bit-equal (forward, backward)")
        del dx, dxr
        if shape not in timed:
            del x, dy
            torch.cuda.empty_cache()
            continue
        # yardstick: one library call over the (1, G*C, R) ghost view (the
        # layout copy is made outside the timing)
        xl = x.transpose(1, 2).reshape(1, G * C, R).contiguous()
        dyl = dy.transpose(1, 2).reshape(1, G * C, R).contiguous()
        gl, bl = gamma.repeat(G), beta.repeat(G)
        _, smean, sinv = torch.ops.aten.native_batch_norm(
            xl, gl, bl, None, None, True, 0.1, 1e-5)
        tp = K.two_pass(G, R, C)
        row = {}
        for pre, kern, two, gate in (
                ("fwd", lambda: K.gbn_forward(x, gamma, beta),
                 lambda: K.forward_with(tp, x, gamma, beta), 1),
                ("bwd", lambda: K.gbn_backward(x, gamma, mur, varr, dy, dmu,
                                               dvar),
                 lambda: K.backward_with(tp, x, gamma, mur, varr, dy, dmu,
                                         dvar), 2)):
            (row[f"{pre}_ms"], row[f"{pre}_device_ms"],
             row[f"{pre}_launches_a_call"]) = gbn_call_times(
                f"{pre} {pf.body}", kern, gate)
            (row[f"{pre}_two_pass_ms"], row[f"{pre}_two_pass_device_ms"],
             row[f"{pre}_two_pass_launches_a_call"]) = gbn_call_times(
                f"{pre} two_pass", two)
        row.update({
            "fwd_plain_ms": time_ms(lambda: ref.gbn_ref(x, gamma, beta)),
            "fwd_library_ms": time_ms(lambda: F.batch_norm(
                xl, None, None, gl, bl, training=True, eps=1e-5)),
            "bwd_plain_ms": time_ms(lambda: ref.gbn_backward_ref(
                x, gamma, mur, varr, dy, dmu, dvar)),
            "bwd_library_ms": time_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dyl, xl, gl, None, None, smean, sinv, True, 1e-5,
                    [True, True, True])),
        })
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(*fwd_work(*shape))
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(*bwd_work(*shape))
        rows[shape] = row
        log("  timing " + json.dumps({k: (round(v, 4) if isinstance(v, float)
                                          else v) for k, v in row.items()}))
        del xl, dyl, x, dy
        torch.cuda.empty_cache()
    for pre in ("fwd", "bwd"):
        step = {k: sum(rows[s][f"{pre}_{k}"] * n for s, n in RESNET_SHAPES)
                for k in ("ms", "device_ms", "two_pass_ms",
                          "two_pass_device_ms", "library_ms")}
        log(f"  {pre} a ResNet44 step (43 calls): " + json.dumps(
            {k: round(v, 4) for k, v in step.items()}))
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
    x = torch.as_tensor(data.x_train[:lb.batch_size], device="cuda")
    y = torch.as_tensor(data.y_train[:lb.batch_size], device="cuda").long()
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
# caches phase 6 times flash_decode over: 16 x 17.8 MB of bf16 K/V; the
# kernel reads ~10 MB of each (the visible slots), so a cache comes round
# again after ~160 MB, three times the card's 50 MB L2; rounds it times
# them in (medians)
DECODE_CACHES, DECODE_ROUNDS = 16, 3
BF16_TOL = 2e-2      # kernel vs plain in bf16: a few bf16 ulps (rtol=atol)
# rows of a 4096-row SwiGLU call held to their solo runs: both warpgroups
# of a block, the edges of 128-row blocks, the last row
INVARIANT_ROWS = (0, 1, 7, 63, 64, 127, 128, 2049, 4095)
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


# Edge shapes of the flash attention kernels, run in bf16 (the tensor-core
# bodies) and held to BF16_TOL: (B, H, KV, T, hd), causal, window,
# kv_offsets (phase 6 only; the RoPE forward and the backward take none).
# T not a multiple of 64, offsets not a multiple of 64, a window,
# non-causal, GQA 2:1, 4:1 and 8:1, hd 32 to 256 (the backward to 128);
# the widths of kimi-k2 (112) and h2o-danube-3-4b (120), which run on
# tiles of 128 with zero columns, at T 17, 100 and 130 (these also in f32
# at TOL: WIDE_HEAD_DIMS).
FLASH_EDGES = [((1, 2, 2, 17, 32), True, None, None),
               ((2, 4, 2, 100, 64), True, 13, (0, 37)),
               ((3, 4, 2, 130, 128), True, None, (0, 7, 129)),
               ((1, 8, 1, 128, 64), False, None, None),
               ((1, 8, 2, 100, 64), True, None, None),
               ((2, 16, 8, 130, 128), True, None, None),
               ((2, 2, 1, 70, 256), True, 9, (64, 0)),
               ((2, 4, 1, 17, 120), True, None, (0, 5)),
               ((2, 8, 2, 100, 120), True, 13, (0, 37)),
               ((1, 4, 2, 130, 120), False, None, None),
               ((3, 8, 1, 130, 112), True, 40, (0, 7, 129)),
               ((1, 4, 4, 100, 112), True, None, None),
               ((2, 16, 8, 17, 112), False, 9, None)]
WIDE_HEAD_DIMS = (112, 120)
# the (H, KV, hd) of the split-KV decode's edge checks: qwen3-1.7b's,
# h2o-danube-3-4b's and kimi-k2's
DECODE_EDGE_WIDTHS = ((16, 8, 128), (32, 8, 120), (64, 8, 112))


def op_labels(events, by_op):
    """{correlation id of a host op: label} for every op that runs inside
    an op named in ``by_op = (ops, scopes)`` ({op name: label}) on the
    same thread (itself included) and inside a host span named in
    ``scopes`` (a ``record_function``, an autograd node): a kernel's
    ``linked_correlation_id`` names the innermost op at its launch, which
    can sit inside the named one (``index_select`` of many rows runs
    ``gather``)."""
    import bisect
    by_name, scopes = by_op

    def spans_of(match):
        spans = {}
        for ev in events:
            if ev.device_type().name == "CPU" and match(ev.name()):
                spans.setdefault(ev.start_thread_id(), []).append(
                    (ev.start_ns(), ev.end_ns(), ev.name()))
        for v in spans.values():
            v.sort()
        return spans, {th: [a for a, _, _ in v] for th, v in spans.items()}

    def enclosing(spans, starts, ev):
        th = ev.start_thread_id()
        if th not in spans:
            return None
        i = bisect.bisect_right(starts[th], ev.start_ns()) - 1
        if i >= 0 and spans[th][i][1] >= ev.end_ns():
            return spans[th][i][2]
        return None

    ops = spans_of(lambda name: name in by_name)
    scoped = spans_of(lambda name: name.split(": ")[-1] in scopes)
    label = {}
    for ev in events:
        if ev.device_type().name != "CPU":
            continue
        op = enclosing(*ops, ev)
        if op is not None and enclosing(*scoped, ev) is not None:
            label[ev.correlation_id()] = by_name[op]
    return label


def profile_device_ms(fn, reps: int = 10, warm: bool = True,
                      host: bool = True, tries: int = 3, by_op=None,
                      host_ops=None):
    """Device time per call of everything ``fn`` launches (torch.profiler,
    after one warm call, the profiler's warmup step, unless ``warm`` is
    off; ``host=False`` records the
    device's activity only), and the kernels by name: (ms, calls, name) per
    call. With ``by_op`` (``op_labels``'s, host activity on; or a function
    of the events giving {correlation id: label}, as ``scope_labels``) a
    kernel launched inside one of its ops and scopes is named "label:
    kernel";
    ``host_ops`` (a dict) receives each host event's ms a call
    and count by name (nested ops each count their whole span). A
    window that comes back with no device event at all (as one has now and
    then on the card, early and late in a run) holds no reading and is
    profiled again, at most ``tries`` times in all; None when none shows
    device time. A window with some events is taken as it is: a kernel
    whose events it lost shows fewer calls a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(tries):
        # the warm call is the profiler's warmup step: traced, its events
        # discarded (late in a run a window's first kernels have gone
        # unrecorded when tracing began with the measured call)
        ready = []
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=int(warm), active=1, repeat=1),
                on_trace_ready=lambda p: ready.append(
                    p.profiler.kineto_results)) as prof:
            for n in [1] * warm + [reps]:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the raw device events, summed by name (a whole engine run holds
        # ~10^6 events, too many to parse into the profiler's event tree)
        by_name = {}
        events = ready[0].events()
        label = ({} if not by_op else by_op(events) if callable(by_op)
                 else op_labels(events, by_op))
        for ev in events:
            if ev.device_type().name == "CUDA" and \
                    not getattr(ev, "is_user_annotation", lambda: False)():
                name = ev.name()
                if ev.linked_correlation_id() in label:
                    name = f"{label[ev.linked_correlation_id()]}: {name}"
                t, n = by_name.get(name, (0, 0))
                by_name[name] = (t + ev.duration_ns(), n + 1)
            elif host_ops is not None and ev.device_type().name == "CPU":
                t, n = host_ops.get(ev.name(), (0, 0))
                host_ops[ev.name()] = (t + ev.duration_ns() / 1e6 / reps,
                                       n + 1)
        kernels = [(t / 1e6 / reps, n // reps, name)
                   for name, (t, n) in by_name.items() if t]
        total = sum(k[0] for k in kernels)
        if total > 0:
            return total, kernels
    return None, kernels


def kernel_ms(fn, reps: int = 10) -> float:
    """Device ms per call (profiler); CUDA events around back-to-back calls
    where the profiler shows no device time."""
    ms, _ = profile_device_ms(fn, reps)
    return ms if ms is not None else time_ms(fn, reps)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_row(name, key, kern, plain, library, work, timer=None, rounds=1):
    """ms a call of a kernel, its plain version and one library call (a
    yardstick the port never calls; None if it fails), and the bound from
    ``work`` = (bytes, operations, peak). ``timer`` defaults to the
    profiler's device time (``kernel_ms``); ``time_ms`` takes CUDA events
    around back-to-back calls instead. With ``rounds`` > 1 the three are
    timed in turn that many times and each time is the median of its
    rounds (one round of a short call can read several times its usual
    time)."""
    import statistics
    timer = timer or kernel_ms
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(rounds):
        times["ms"].append(timer(kern))
        times["plain_ms"].append(timer(plain))
        if None in times["library_ms"]:
            continue
        try:
            times["library_ms"].append(timer(library))
        except Exception as e:
            log(f"  library yardstick of {name} failed: {e!r}")
            times["library_ms"].append(None)
    row = {k: (None if None in v else statistics.median(v))
           for k, v in times.items()}
    if rounds > 1:
        log(f"  timing {name} {key}, {rounds} rounds: " + json.dumps(
            {k: [None if x is None else round(x, 4) for x in v]
             for k, v in times.items()}))
    row["bound_ms"], row["bound_by"] = bound(*work)
    row["work"] = work
    log(f"  timing {name} {key}: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in row.items() if k != "work"}))
    return row


def norm_work(N, d, esize=2, residual=True):
    # read x (and r), scale; write y (and s); ~5 f32 ops an element
    return esize * (4 if residual else 2) * N * d + 4 * d, 5.0 * N * d, \
        F32_FLOPS


# B3 and B4 are checked at every width of the repo's configs (1024 to
# 5376, kimi-k2's 7168) and at MAX_D, in bf16, at one row, a decode batch
# and a prefill or train step; rows of a 4096-row call held to their solo
# calls: the ends of warps and of 32-row runs, and the last row
NORM_WIDTHS = (1024, 2048, 3840, 4096, 5120, 5376, 7168, 8192)
NORM_ROWS = (1, 8, 4096)
NORM_INVARIANT_ROWS = (0, 1, 7, 31, 32, 63, 4095)


def norm_widths(backward, record, record_sum=None):
    """B3 (``backward`` False) or B4 against its plain version at every
    NORM_WIDTHS x NORM_ROWS in bf16, with and without the residual (BF16_TOL;
    dscale relative to its largest entry); at 4096 rows with the residual,
    two calls bit-equal and the NORM_INVARIANT_ROWS bit-equal to their solo
    calls (y and s; dx), and the CUDA-events ms a call (``queued_ms``,
    going round copies of the inputs past the L2: ``input_copies``) beside
    the bound.
    Returns {d: {"ms", "bound_ms", "plan"}}."""
    import torch
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import launch as L
    from repro_torch.kernels import ref
    name = "rmsnorm_residual_backward" if backward else "rmsnorm_residual"
    gen = torch.Generator(device="cuda").manual_seed(17)
    sms = L.sm_count(torch.cuda.current_device())
    times = {}
    for d in NORM_WIDTHS:
        scale = torch.linspace(0.5, 1.5, d, device="cuda")
        for N in NORM_ROWS:
            a, b, c = (torch.randn(N, d, generator=gen, device="cuda")
                       .bfloat16() for _ in range(3))
            for res in (True, False):
                label = f"({N}, {d}) bf16{'' if res else ' no residual'}"
                if backward:
                    dsv = c if res else None
                    dx, dsc = FN.rmsnorm_residual_backward(a, scale, b, dsv)
                    rdx, rdsc = ref.rmsnorm_residual_backward_ref(a, scale, b,
                                                                  dsv)
                    record(name, label + " dx", dx, rdx, BF16_TOL)
                    record_sum(name, label + " dscale", dsc, rdsc, BF16_TOL)
                else:
                    rv = b if res else None
                    record(name, label,
                           torch.cat(FN.rmsnorm_residual(a, rv, scale)),
                           torch.cat(ref.rmsnorm_residual_ref(a, rv, scale)),
                           BF16_TOL)
        if backward:            # a, b, c: the 4096-row inputs
            first = FN.rmsnorm_residual_backward(a, scale, b, c)
            again = FN.rmsnorm_residual_backward(a, scale, b, c)
            if not (first[0].equal(again[0]) and first[1].equal(again[1])):
                raise AssertionError(f"{name} d={d}: two calls differ")
            check_rows_solo(
                f"{name} d={d} dx",
                lambda s_, dy_, ds_: FN.rmsnorm_residual_backward(
                    s_, scale, dy_, ds_)[:1],
                (a, b, c), (0, 1, 2), NORM_INVARIANT_ROWS)
            ms = queued_ms(rotating(
                lambda s_, dy_, ds_: FN.rmsnorm_residual_backward(
                    s_, scale, dy_, ds_), input_copies(a, b, c)))
            bms = bound(*norm_bwd_work(N, d))[0]
        else:
            check_rows_solo(
                f"{name} d={d} y, s",
                lambda x_, r_: FN.rmsnorm_residual(x_, r_, scale),
                (a, b), (0, 1), NORM_INVARIANT_ROWS)
            ms = queued_ms(rotating(
                lambda x_, r_: FN.rmsnorm_residual(x_, r_, scale),
                input_copies(a, b)))
            bms = bound(*norm_work(N, d))[0]
        p = FN.plan(N, d, sms, backward=backward)
        times[d] = {"ms": ms, "bound_ms": bms,
                    "plan": f"{p.body} {p.warps}w K{p.per_lane} "
                            f"{p.teams_per_block}t x {p.blocks}b"}
        log(f"  {name} ({N}, {d}) bf16: {ms:.4f} ms a call (events), bound "
            f"{bms:.4f} ({bms / ms:.2f} of it); plan {times[d]['plan']}")
        del a, b, c
    return times


def norm_width_line(fwd, bwd):
    """The per-width ms a call of B3 and B4 at 4096 rows (bf16, residual)."""
    return ("norm widths (4096 rows bf16, residual; events ms a call / "
            "bound): " + ", ".join(
                f"d={d} B3 {fwd[d]['ms']:.4f}/{fwd[d]['bound_ms']:.4f} B4 "
                f"{bwd[d]['ms']:.4f}/{bwd[d]['bound_ms']:.4f}"
                for d in NORM_WIDTHS))


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

    def timed(name, key, kern, plain, library, work, rounds=1):
        out[name][key] = time_row(name, key, kern, plain, library, work,
                                  rounds=rounds)

    # rmsnorm_residual -------------------------------------------------------
    log("kernel check rmsnorm_residual")
    scale = torch.linspace(0.5, 1.5, d, device="cuda")
    scale_bf = scale.bfloat16()
    for N in (P * B, B):
        x, r = randn(N, d), randn(N, d)
        record("rmsnorm_residual", f"({N}, {d}) bf16",
               torch.cat(FN.rmsnorm_residual(x, r, scale)),
               torch.cat(ref.rmsnorm_residual_ref(x, r, scale)), BF16_TOL)
        xr, xs = input_copies(x, r), input_copies(x)
        timed("rmsnorm_residual", N,
              rotating(lambda x, r: FN.rmsnorm_residual(x, r, scale), xr),
              rotating(lambda x, r: ref.rmsnorm_residual_ref(x, r, scale),
                       xr),
              rotating(lambda x, r: F.rms_norm(x + r, (d,), scale_bf, 1e-6),
                       xr),
              norm_work(N, d))
        # no residual: each layer's pre-attention norm and the final norm
        record("rmsnorm_residual", f"({N}, {d}) bf16 no residual",
               FN.rmsnorm_residual(x, None, scale)[0],
               ref.rmsnorm_residual_ref(x, None, scale)[0], BF16_TOL)
        timed("rmsnorm_residual", (N, "no residual"),
              rotating(lambda x: FN.rmsnorm_residual(x, None, scale), xs),
              rotating(lambda x: ref.rmsnorm_residual_ref(x, None, scale),
                       xs),
              rotating(lambda x: F.rms_norm(x, (d,), scale_bf, 1e-6), xs),
              norm_work(N, d, residual=False))
        del xr, xs
    # (4096, 2048) also by CUDA events, the (1, 128) call's device time
    # (the kernel's fixed cost, beside which decode calls are read)
    x, r = randn(P * B, d), randn(P * B, d)
    out["rmsnorm_residual"]["events_ms"] = queued_ms(rotating(
        lambda x, r: FN.rmsnorm_residual(x, r, scale), input_copies(x, r)))
    x, r = randn(1, 128), randn(1, 128)
    s128 = torch.linspace(0.5, 1.5, 128, device="cuda")
    timed("rmsnorm_residual", "fixed cost (1, 128)",
          lambda: FN.rmsnorm_residual(x, r, s128),
          lambda: ref.rmsnorm_residual_ref(x, r, s128),
          lambda: F.rms_norm(x + r, (128,), s128.bfloat16(), 1e-6),
          norm_work(1, 128))
    # the small f32 shapes, widths off the 16-byte chunk and an unaligned
    # view (the scalar path)
    for n_, d_ in ((17, 128), (5, 100), (300, 7)):
        x, r = (randn(n_, d_, dt=torch.float32) for _ in range(2))
        sc_ = torch.linspace(0.5, 1.5, d_, device="cuda")
        for rv in (r, None):
            record("rmsnorm_residual", f"({n_}, {d_}) f32"
                   + ("" if rv is not None else " no residual"),
                   torch.cat(FN.rmsnorm_residual(x, rv, sc_)),
                   torch.cat(ref.rmsnorm_residual_ref(x, rv, sc_)), TOL)
    flat = randn(4 * 256 + 1)
    x, r = flat[1:].view(4, 256), flat[:-1].view(4, 256)
    record("rmsnorm_residual", "(4, 256) bf16 unaligned views",
           torch.cat(FN.rmsnorm_residual(x, r, scale[:256])),
           torch.cat(ref.rmsnorm_residual_ref(x, r, scale[:256])), BF16_TOL)
    out["rmsnorm_residual"]["widths"] = norm_widths(False, record)
    del x, r, flat

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
        if N == P * B:
            check_rows_solo("swiglu", SW.swiglu, (x, wg, wu), (0,),
                            INVARIANT_ROWS)
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
    for (b_, h_, kv_, t_, hd_), causal, window, offs in FLASH_EDGES:
        qe = randn(b_, h_, t_, hd_)
        ke, ve = randn(b_, kv_, t_, hd_), randn(b_, kv_, t_, hd_)
        oe = None if offs is None else torch.tensor(offs, device="cuda",
                                                    dtype=torch.int32)
        dts = [(torch.bfloat16, BF16_TOL)] + (
            [(torch.float32, TOL)] if hd_ in WIDE_HEAD_DIMS else [])
        for dt, tol in dts:
            qd, kd, vd = (t.to(dt) for t in (qe, ke, ve))
            go, gl = FA.flash_attention_fwd(qd, kd, vd, causal=causal,
                                            window=window, kv_offsets=oe,
                                            return_lse=True)
            wo, wl = ref.attention_ref(qd, kd, vd, causal=causal,
                                       window=window, kv_offsets=oe,
                                       return_lse=True)
            label = (f"({b_}, {h_}, {kv_}, {t_}, {hd_}) {str(dt)[6:]} "
                     f"causal {causal} window {window} offsets {offs}")
            record("flash_attention", label + " o", go, wo, tol)
            # lse from f32 logits of the same inputs: -inf rows agree
            fin = wl.isfinite()
            if not torch.equal(fin, gl.isfinite()):
                raise AssertionError(f"flash_attention {label}: -inf rows "
                                     f"differ")
            record("flash_attention", label + " lse", gl[fin], wl[fin], TOL)
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
    # each layer of a generate reads its own cache from device memory: each
    # timed call takes the next of DECODE_CACHES caches (more than L2)
    caches = [(k, v)] + [(randn(B, KV, S, hd), randn(B, KV, S, hd))
                         for _ in range(DECODE_CACHES - 1)]

    for pos in (first, last):
        vis = [pos - (P - L) + 1 for L in PROMPT_LENS]
        slots = torch.arange(S, device="cuda")
        dmask = ((slots[None, :] <= pos)
                 & (slots[None, :] >= off[:, None].long()))[:, None, None]
        qr = ref.rope_rotate(q, (pos - off.long())[:, None].expand(B, H),
                             theta).bfloat16()[:, :, None]
        timed("flash_decode", pos,
              rotating(lambda k_, v_, p=pos: FD.flash_decode(
                  q, k_, v_, p, offsets=off, rope_theta=theta), caches),
              rotating(lambda k_, v_, p=pos: ref.flash_decode_ref(
                  q, k_, v_, p, offsets=off, rope_theta=theta), caches),
              rotating(lambda k_, v_, qr=qr, m=dmask:
                       F.scaled_dot_product_attention(
                           qr, k_, v_, attn_mask=m, enable_gqa=True),
                       caches),
              decode_work(B, H, KV, hd, vis), rounds=DECODE_ROUNDS)
        warm = [kernel_ms(lambda p=pos: FD.flash_decode(
            q, k, v, p, offsets=off, rope_theta=theta))
            for _ in range(DECODE_ROUNDS)]
        out["flash_decode"][(pos, "warm")] = sorted(warm)[len(warm) // 2]
        log(f"  timing flash_decode {pos} on one cache over and over "
            f"(L2-warm, as this phase used to time it): median "
            f"{sorted(warm)[len(warm) // 2]:.4f} ms a call; rounds "
            f"{[round(w, 4) for w in warm]}")
    del caches
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
    out["flash_decode"]["err"] = max(
        [out["flash_decode"]["err"]] + [decode_edge_checks(False, *w)
                                        for w in DECODE_EDGE_WIDTHS])
    torch.cuda.empty_cache()
    return out


def ragged_prompts(vocab: int, seed: int, P=None, lens=None):
    """(B, P) left-padded prompts of ``lens`` real tokens (SERVE_P and
    PROMPT_LENS unless given), from ``seed``."""
    import torch
    P = SERVE_P if P is None else P
    lens = PROMPT_LENS if lens is None else lens
    g = torch.Generator().manual_seed(seed)
    full = torch.randint(0, vocab, (len(lens), P), generator=g)
    lens = torch.tensor(lens)
    real = torch.arange(P)[None] >= P - lens[:, None]
    return torch.where(real, full, 0).cuda()


def serving_launches():
    """Every launch counter of the decoder kernels (serving and training)."""
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
    scope, sep, kernel = name.partition(": ")
    if sep and scope in MEMORY_SCOPES:  # launched in the encoder or a
        inner = family(kernel)          # cross-attention: its B-kernels
        return scope if inner in ("cublas_gemm", "other") else inner
    if name.startswith("moe_"):         # named by its op (MOE_OPS)
        return name.split(":")[0]
    n = name.lower()
    if "rmsnorm_residual_bwd" in n or "rmsnorm_residual_dscale" in n:
        return "rmsnorm_residual_bwd"
    if "mamba_dbc_reduce" in n:         # B11's second stage
        return "mamba_chunk_bwd"
    for fam in ("flash_decode_paged", "flash_decode", "flash_fwd",
                "flash_bwd", "swiglu_bwd", "swiglu", "rmsnorm_residual",
                "mamba_chunk_fwd", "mamba_chunk_bwd"):
        if fam in n:
            return fam
    if any(s in n for s in ("gemm", "gemv", "sm90", "cutlass", "xmma",
                            "cublas", "nvjet")):
        return "cublas_gemm"
    return "other"


def by_family(kernels):
    """(device ms, kernels) of each family of profiled (ms, calls, name)."""
    fam, calls = {}, {}
    for t, count, name in kernels:
        fam[family(name)] = fam.get(family(name), 0.0) + t
        calls[family(name)] = calls.get(family(name), 0) + count
    return fam, calls


def family_profile(label, fn, by_op=None):
    """Host ms of one synchronized call and one profiled call's device ms
    by kernel family (``by_op`` as ``profile_device_ms``): {"host_ms",
    "busy_ms", "families", "calls"}."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    host_ops = {} if by_op else None
    busy, kernels = profile_device_ms(fn, reps=1, by_op=by_op,
                                      host_ops=host_ops)
    fam, calls = by_family(kernels)
    busy = busy or 0.0
    log(f"  profile {label}: device ms by family "
        f"{ {k: round(v, 3) for k, v in sorted(fam.items())} } (kernels "
        f"{dict(sorted(calls.items()))}); busy {busy:.3f} ms of a "
        f"{host_ms:.3f} ms call (idle share {1 - busy / host_ms:.3f})")
    if host_ops:
        log("    host events by total ms (nested ops count their whole "
            "span): " + ", ".join(
                f"{name} {t:.3f} x{n}" for name, (t, n) in sorted(
                    host_ops.items(), key=lambda kv: -kv[1][0])[:16]))
    # the eight longest kernels, then each other kernel of the port's own
    # families (the launches of a multi-kernel call, such as B6's gate and
    # dx kernels, one by one)
    ranked = sorted(kernels, reverse=True)
    for t, count, name in ranked[:8] + [
            k for k in ranked[8:]
            if family(k[2]) not in ("other", "cublas_gemm")]:
        log(f"    {t:9.3f} ms  x{count:<4d} {name[:80]}")
    return {"host_ms": host_ms, "busy_ms": busy, "families": fam,
            "calls": calls}


def model_params(cfg):
    """Random weights from SERVE_SEED at the config's widths, drawn on the
    card in its dtype."""
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer as TT
    t0 = time.perf_counter()
    params = TT.init_params(SERVE_SEED, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    kinds = sorted({f"{s.mixer}+{s.ff}" + ("+cross" if s.cross_attn else "")
                    for s in cfg.layers})
    extra = ""
    if cfg.encoder is not None:
        e = cfg.encoder
        extra = (f", encoder {e.n_layers} layers d_model {e.d_model} heads "
                 f"{e.n_heads}/{e.n_kv_heads} d_ff {e.d_ff}")
    if cfg.ssm is not None:
        extra += (f", d_inner {cfg.ssm.d_inner(cfg.d_model)} d_state "
                  f"{cfg.ssm.d_state} dt_rank "
                  f"{cfg.ssm.resolved_dt_rank(cfg.d_model)}")
    if cfg.moe is not None:
        m = cfg.moe
        extra += (f", {m.n_experts} experts top-{m.top_k} d_expert "
                  f"{m.d_expert}, shared d {m.d_shared}, capacity factor "
                  f"{m.capacity_factor}")
    log(f"{cfg.name}: {cfg.n_layers} layers ({', '.join(kinds)}) d_model "
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd "
        f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}){extra}, {n_params / 1e9:.3f} B parameters in "
        f"{cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    return params


def serve_params():
    """Full-width qwen3-1.7b in bf16, random weights from SERVE_SEED (phases
    7 and 10 share them)."""
    from repro_torch.configs import get_config
    return model_params(get_config(SERVE_ARCH))


def phase_serve(params):
    """Full-width qwen3-1.7b generate in bf16 on one card: B=8 left-padded
    prompts of width 512 (PROMPT_LENS), greedy, 32 new tokens, through the
    four serving kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate, make_serve_step, prefill_fused
    cfg = get_config(SERVE_ARCH)
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
    # every forward pass: the fused residual norm and the pre-attention
    # norm of each layer, and the final norm
    want = {"flash_attention": L, "flash_decode": L * (n - 1),
            "flash_decode_paged": 0, "rmsnorm_residual": (2 * L + 1) * n,
            "swiglu": L * n, "flash_attention_rope": 0,
            "flash_attention_backward": 0, "rmsnorm_residual_backward": 0,
            "swiglu_backward": 0}
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
    breakdown = {
        "decode step": family_profile("decode step", lambda: step(
            params, cache, tok, SERVE_P + n - 2, offsets=off)),
        "prefill": family_profile("prefill", lambda: prefill_fused(
            params, cfg, prompts, TT.init_cache(cfg, SERVE_B, SERVE_P + n),
            offsets=off))}
    del cache
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

# ---------------------------------------------------------------------------
# continuous serving: the paged decode kernel and ContinuousEngine
# ---------------------------------------------------------------------------

ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_PAGE = 16, 1024, 16
ENGINE_LAYERS = 8    # phase 10's depth: full width, cut from 28 layers
ENGINE_TRACE = dict(n_requests=32, rate=0.25,
                    prompt_len_choices=(128, 256, 512),
                    new_token_choices=(32, 64, 128), seed=0)
PAGED_REPLACES = "src/repro/kernels/flash_decode.py:360"
PAGED_POOLS, PAGED_ROUNDS, PAGED_STATES = 4, 3, 4
# the reference's paged cases (tests/test_serving_continuous.py:54-58):
# B, H, KV, NB, page_size, hd, window, offsets
PAGED_CASES = [(2, 4, 4, 4, 16, 64, None, None),
               (2, 4, 2, 4, 16, 64, None, None),
               (2, 8, 2, 4, 16, 64, 24, None),
               (3, 4, 1, 2, 32, 32, None, (0, 5, 40)),
               # the same at kimi-k2's and h2o-danube-3-4b's widths
               (2, 8, 2, 4, 16, 112, 24, None),
               (3, 4, 1, 2, 32, 120, None, (0, 5, 40)),
               (2, 8, 8, 4, 16, 120, 24, (0, 9))]


def paged_from_contiguous(k, v, ps: int, seed: int = 0):
    """A contiguous (B, KV, S, hd) cache scattered into a page pool of
    1 + B * S / ps pages through a shuffled block table (page 0 kept as the
    trash page). Returns (kp, vp, pt int32)."""
    import numpy as np
    import torch
    B, KV, S, hd = k.shape
    NB = S // ps
    perm = np.random.RandomState(seed).permutation(np.arange(1, 1 + B * NB))
    pt = torch.tensor(perm.reshape(B, NB), dtype=torch.int32,
                      device=k.device)

    def pool(x):
        blocks = x.reshape(B, KV, NB, ps, hd).transpose(1, 2)
        p = torch.zeros((1 + B * NB, KV, ps, hd), dtype=x.dtype,
                        device=x.device)
        p[pt.reshape(-1).long()] = blocks.reshape(B * NB, KV, ps, hd)
        return p

    return pool(k), pool(v), pt


def phase_paged_kernel():
    """Phase 9's checks: the paged kernel against its plain version on the
    card, and bit-equal to flash_decode on the same cache contents.
    Returns the max abs error over every check."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = [0.0]

    def inputs(B, H, KV, S, hd, dt=torch.float32):
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(B, KV, S, hd, generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        return q, k, v

    def record(label, tol, *args, **kw):
        got = FD.flash_decode_paged(*args, **kw)
        want = ref.flash_decode_paged_ref(*args, **kw)
        torch.cuda.synchronize()
        errs.append(check_close(f"paged {label}", got.float(), want.float(),
                                tol))
        return got

    log("kernel check flash_decode_paged")
    for B, H, KV, NB, ps, hd, window, offs in PAGED_CASES:
        S = NB * ps
        q, k, v = inputs(B, H, KV, S, hd)
        off = None if offs is None else torch.tensor(offs, device="cuda",
                                                     dtype=torch.int32)
        lo = 0 if offs is None else max(offs)
        pos = torch.tensor([max(lo, S - 1 - 7 * i) for i in range(B)],
                           device="cuda", dtype=torch.int32)
        kp, vp, pt = paged_from_contiguous(k, v, ps, seed=B + NB)
        for theta in (None, 1e4):
            record(f"({B}, {H}/{KV}, NB={NB}, ps={ps}, {hd}) window={window}"
                   f" offsets={offs} rope={theta} f32", TOL, q, kp, vp, pt,
                   pos, window=window, offsets=off, rope_theta=theta)
    # trash-page tails and an all-trash row
    q, k, v = inputs(2, 4, 2, 64, 64)
    kp, vp, pt = paged_from_contiguous(k, v, 16)
    pos = torch.tensor([19, 31], device="cuda", dtype=torch.int32)
    full = FD.flash_decode_paged(q, kp, vp, pt, pos)
    trashed = pt.clone()
    trashed[:, 2:] = 0
    tail = record("trash-page tails f32", TOL, q, kp, vp, trashed, pos)
    dead = record("all-trash rows f32", TOL, q, kp, vp,
                  torch.zeros_like(pt), pos)
    if not torch.equal(tail, full) or not bool(torch.isfinite(dead).all()):
        raise AssertionError("trash pages past pos changed the output, or "
                             "an all-trash row is not finite")
    # an int8 pool, without and with window or RoPE
    (kq, ks), (vq, vs) = ref.quantize_slots(kp), ref.quantize_slots(vp)
    pos = torch.tensor([63, 35], device="cuda", dtype=torch.int32)
    for window, theta in ((None, None), (24, None), (None, 1e4)):
        record(f"int8 pool window={window} rope={theta} f32", TOL, q, kq, vq,
               pt, pos, window=window, k_scale=ks, v_scale=vs,
               rope_theta=theta)
    # the engine's full-width shape in bf16, and bit-equality
    cfg = get_config(SERVE_ARCH)
    B, S = ENGINE_SLOTS, ENGINE_MAX_LEN
    q, k, v = inputs(B, cfg.n_heads, cfg.n_kv_heads, S, cfg.head_dim,
                     torch.bfloat16)
    kp, vp, pt = paged_from_contiguous(k, v, ENGINE_PAGE)
    # rows at depths 128, 184, ..., 968 (phase 10 has not run yet)
    pos = torch.arange(B, device="cuda", dtype=torch.int32) * 56 + 128
    theta = cfg.rope_theta
    off = (torch.arange(B, device="cuda", dtype=torch.int32) * 7) % 64
    label = (f"B={B} H={cfg.n_heads} KV={cfg.n_kv_heads} pages "
             f"{kp.shape[0]}x{ENGINE_PAGE} hd={cfg.head_dim}")
    for offsets in (None, off):
        got = record(f"{label} offsets={offsets is not None} rope bf16",
                     BF16_TOL, q, kp, vp, pt, pos, offsets=offsets,
                     rope_theta=theta)
        same = torch.equal(got, FD.flash_decode(q, k, v, pos,
                                                offsets=offsets,
                                                rope_theta=theta))
        log(f"  paged == flash_decode on the contiguous cache, bit for bit "
            f"(offsets={offsets is not None}): {same}")
        if not same:
            raise AssertionError("the paged kernel differs from flash_decode "
                                 "on the same cache contents")
    (kq, ks), (vq, vs) = ref.quantize_slots(kp), ref.quantize_slots(vp)
    record(f"{label} int8 pool rope bf16 q", BF16_TOL, q, kq, vq, pt, pos,
           k_scale=ks, v_scale=vs, rope_theta=theta)
    del q, k, v, kp, vp, kq, vq
    errs += [decode_edge_checks(True, *w) for w in DECODE_EDGE_WIDTHS]
    torch.cuda.empty_cache()
    return max(errs)


def decode_edge_checks(paged: bool, H: int = 16, KV: int = 8,
                       hd: int = 128) -> float:
    """The split-KV decode body's edges at one width (H, KV, hd; qwen3-1.7b's
    by default, DECODE_EDGE_WIDTHS), for flash_decode (f32 and bf16 caches)
    or flash_decode_paged
    (every pool type: f32, bf16, int8 with f32 and with bf16 queries; pages
    of ENGINE_PAGE through a shuffled block table):

    - rows at positions CHUNK - 1, CHUNK, CHUNK + 1 and 2 CHUNK (CHUNK =
      ``FD.chunk_slots``), plain, with ragged offsets and RoPE, with a
      window of CHUNK, and with offsets past pos (rows that see no slot:
      the mean of V): against the plain version (TOL, BF16_TOL); the paged
      kernel on a pool of q's dtype bit-equal to flash_decode;
    - a cache of S = 544 slots against the same contents padded to 1024
      (random slots past every row's pos; paged: a block table of 34 pages
      against 64, the trash page past pos): equal bits;
    - the rows of batches of 1, 8 and 16 at their own depths bit-equal to
      their solo runs.

    Returns the max abs error against the plain versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ref
    cfg = get_config(SERVE_ARCH)
    ps = ENGINE_PAGE
    gen = torch.Generator(device="cuda").manual_seed(31 + int(paged) + hd)
    name = "flash_decode_paged" if paged else "flash_decode"
    types = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)]
    if paged:
        types += [(torch.float32, "int8"), (torch.bfloat16, "int8")]
    errs = [0.0]

    def ints(*xs):
        return torch.tensor(xs, device="cuda", dtype=torch.int32)

    for qdt, pool in types:
        tol = TOL if qdt == torch.float32 else BF16_TOL
        itemsize = 1 if pool == "int8" else torch.finfo(qdt).bits // 8
        n = FD.chunk_slots(hd, itemsize)
        label = (f"{name} H={H} KV={KV} hd={hd} q {str(qdt)[6:]} cache "
                 f"{pool if pool == 'int8' else str(pool)[6:]}")

        def cache(B, S):
            q = torch.randn(B, H, hd, generator=gen, device="cuda").to(qdt)
            k, v = (torch.randn(B, KV, S, hd, generator=gen, device="cuda")
                    .to(qdt) for _ in range(2))
            if not paged:
                return q, (k, v), None, (k, v, {})
            kp, vp, pt = paged_from_contiguous(k, v, ps, seed=B + S)
            if pool == "int8":
                (kp, ks), (vp, vs) = (ref.quantize_slots(kp),
                                      ref.quantize_slots(vp))
                return q, (k, v), pt, (kp, vp, dict(k_scale=ks, v_scale=vs))
            return q, (k, v), pt, (kp, vp, {})

        def run(q, src, pt, pos, plain=False, **kw):
            a, b_, sc = src
            if paged:
                fn = ref.flash_decode_paged_ref if plain \
                    else FD.flash_decode_paged
                return fn(q, a, b_, pt, pos, **kw, **sc)
            fn = ref.flash_decode_ref if plain else FD.flash_decode
            return fn(q, a, b_, pos, **kw)

        # chunk edges
        q, (k, v), pt, src = cache(4, -(-(2 * n + 9) // ps) * ps)
        pos, off = ints(n - 1, n, n + 1, 2 * n), ints(0, n - 1, n, 1)
        keyless = ints(0, n + 1, n + 2, 2 * n + 1)     # rows 1-3 see none
        for kw in (dict(), dict(offsets=off, rope_theta=cfg.rope_theta),
                   dict(window=n), dict(offsets=keyless)):
            got = run(q, src, pt, pos, **kw)
            errs.append(check_close(
                f"{label} positions {n - 1}..{2 * n} {sorted(kw)}",
                got.float(), run(q, src, pt, pos, plain=True, **kw).float(),
                tol))
            if paged and pool != "int8" and not torch.equal(
                    got, FD.flash_decode(q, k, v, pos, **kw)):
                raise AssertionError(f"{label}: differs from flash_decode "
                                     f"at the chunk edges {sorted(kw)}")
        # S = 544 against the same contents padded to S = 1024
        q, (k, v), pt, src = cache(3, 544)
        pos, off = ints(543, 64, 400), ints(0, 37, 300)
        if paged:
            longer = (src, torch.cat([pt, torch.zeros(
                3, 64 - pt.shape[1], device="cuda", dtype=torch.int32)], 1))
        else:
            pad = (lambda x: torch.cat([x, torch.randn(  # noqa: E731
                3, KV, 1024 - 544, hd, generator=gen, device="cuda")
                .to(qdt)], 2))
            longer = ((pad(k), pad(v), {}), None)
        for kw in (dict(), dict(offsets=off, rope_theta=cfg.rope_theta)):
            if not torch.equal(run(q, src, pt, pos, **kw),
                               run(q, longer[0], longer[1], pos, **kw)):
                raise AssertionError(f"{label}: S = 544 and S = 1024 "
                                     f"differ {sorted(kw)}")
        # rows of batches of 1, 8 and 16 against their solo runs
        for B in (1, 8, 16):
            q, (k, v), pt, src = cache(B, 640)
            pos = (torch.arange(B, device="cuda", dtype=torch.int32) * 37
                   + 60) % 640
            off = torch.minimum((torch.arange(
                B, device="cuda", dtype=torch.int32) * 7) % 50, pos)
            kw = dict(rope_theta=cfg.rope_theta)
            many = run(q, src, pt, pos, offsets=off, **kw)
            for r in range(B):
                one = slice(r, r + 1)
                src_r = src if paged else (k[one], v[one], {})
                solo = run(q[one], src_r, None if pt is None else pt[one],
                           pos[one], offsets=off[one], **kw)
                if not torch.equal(many[r], solo[0]):
                    raise AssertionError(f"{label}: row {r} of {B} differs "
                                         f"from its solo run")
        log(f"  {label}: chunk of {n} slots; edges within tolerance, S = 544 "
            f"and 1024 bit-equal, rows of 1, 8, 16 bit-equal to their solo "
            f"runs")
    torch.cuda.empty_cache()
    return max(errs)


def paged_work(pos, KV, H, hd, ps, esize, int8=False):
    """Bytes and operations one paged decode call needs at row positions
    ``pos``: q in and o out, the visible slots' K and V (and their f32
    scales for an int8 pool) and the table entries of their blocks; QK and
    PV over the visible slots."""
    vis = [int(p) + 1 for p in pos]
    slot = 2 * KV * hd * (1 if int8 else esize) + (2 * KV * 4 if int8 else 0)
    nbytes = 2 * len(vis) * H * hd * esize + slot * sum(vis) \
        + 4 * sum(-(-n // ps) for n in vis)
    return nbytes, 4.0 * hd * H * sum(vis), BF16_FLOPS


def phase_paged_timing(states):
    """Device ms per call of the paged kernel (bf16 and int8 pools), its
    plain version and the library yardstick at full width, at the per-row
    position vectors ``states`` sampled across phase 10's run. Each timed
    function rotates through PAGED_POOLS distinct pools (268 MB of bf16
    K/V, more than the card's 50 MB L2), so K/V come from device memory as
    in the engine, where every layer has a pool of its own. The functions
    are timed in turn for PAGED_ROUNDS rounds; a time is the median of its
    rounds. Returns [{key: median ms}] per state and the rounds' spread."""
    import statistics
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ref
    cfg = get_config(SERVE_ARCH)
    H, KV, hd, ps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ENGINE_PAGE
    B, S = ENGINE_SLOTS, ENGINE_MAX_LEN
    theta = cfg.rope_theta
    gen = torch.Generator(device="cuda").manual_seed(17)
    q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
    pools = []
    for i in range(PAGED_POOLS):
        k, v = (torch.randn(B, KV, S, hd, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        kp, vp, pt = paged_from_contiguous(k, v, ps, seed=5 + i)
        del k, v
        (kq, ks), (vq, vs) = ref.quantize_slots(kp), ref.quantize_slots(vp)
        pools.append((kp, vp, pt, kq, ks, vq, vs))

    def functions(pos):
        qr = ref.rope_rotate(q, pos[:, None].long().expand(B, H),
                             theta).bfloat16()[:, :, None]
        mask = (torch.arange(S, device="cuda")[None, :]
                <= pos[:, None].long())[:, None, None]

        def library(kp, vp, pt, *_):
            rows = pt.long()
            kg = kp[rows].transpose(1, 2).reshape(B, KV, S, hd)
            vg = vp[rows].transpose(1, 2).reshape(B, KV, S, hd)
            return F.scaled_dot_product_attention(qr, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)

        return {
            "ms": rotating(lambda kp, vp, pt, *_: FD.flash_decode_paged(
                q, kp, vp, pt, pos, rope_theta=theta), pools),
            "int8_ms": rotating(lambda kp, vp, pt, kq, ks, vq, vs:
                                FD.flash_decode_paged(
                                    q, kq, vq, pt, pos, k_scale=ks,
                                    v_scale=vs, rope_theta=theta), pools),
            "plain_ms": rotating(lambda kp, vp, pt, *_:
                                 ref.flash_decode_paged_ref(
                                     q, kp, vp, pt, pos, rope_theta=theta),
                                 pools),
            "library_ms": rotating(library, pools)}

    fns = [functions(torch.tensor(p, device="cuda", dtype=torch.int32))
           for p in states]
    times = [{k: [] for k in f} for f in fns]
    for _ in range(PAGED_ROUNDS):
        for f, t in zip(fns, times):
            for key, fn in f.items():
                try:
                    t[key].append(kernel_ms(fn))
                except Exception as e:
                    if key != "library_ms":
                        raise
                    # a yardstick only: the port never calls it
                    log(f"  library yardstick of flash_decode_paged failed: "
                        f"{e!r}")
                    t[key].append(None)
    out = []
    for p, t in zip(states, times):
        row = {k: (None if None in v else statistics.median(v))
               for k, v in t.items()}
        out.append(row)
        log(f"  timing flash_decode_paged, cold pools, {PAGED_ROUNDS} "
            f"rounds, {sum(int(x) + 1 for x in p)} visible slots (pos "
            f"{list(map(int, p))}): median " + json.dumps(
                {k: (None if v is None else round(v, 4))
                 for k, v in row.items()}) + "; rounds " + json.dumps(
                {k: [None if x is None else round(x, 4) for x in v]
                 for k, v in t.items()}))
    del pools
    torch.cuda.empty_cache()
    return out


def pool_bytes(cache) -> int:
    """Bytes of the distinct page-pool tensors (kp/vp, and ks/vs) of a
    cache tree."""
    from repro_torch import tree
    seen = {}
    for t in tree.leaves(cache):
        if t.dim() >= 3:         # pools and scale planes, not the table
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


class _Stop(Exception):
    pass


def solo_logits(params, cfg, prompt, want, d):
    """The f32 logits (vocab) from which a solo run of ``prompt`` that
    generated ``want`` picked its token ``d``."""
    import torch
    from repro_torch.models import transformer as TT
    from repro_torch.serving import prefill_fused
    P = len(prompt)
    toks = torch.as_tensor(prompt, device="cuda")[None].long()
    cache = TT.init_cache(cfg, 1, P + len(want))
    logits, cache = prefill_fused(params, cfg, toks, cache)
    for i in range(d):
        tok = torch.tensor([[want[i]]], device="cuda")
        lg, cache = TT.decode_step(params, cfg, tok, cache, P + i)
        logits = lg[:, -1]
    return logits.float()[0, :cfg.vocab_size]


def solo_divergence(params, cfg, prompt, want, got):
    """The first step where a solo run and the engine disagree, and the
    solo run's top-2 logit gap there."""
    import torch
    d = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    top = torch.topk(solo_logits(params, cfg, prompt, want, d), 2).values
    return d, float(top[0] - top[1])


def batch_invariance_probe(params):
    """What makes a batched decode row equal its solo run: for each op of
    the decode step, the number of output values of 16 rows computed
    together that differ from the same rows computed one at a time (f32
    where the op's reduction is the question, bf16 for the projections).
    A measurement printed beside phase 10, not a gate."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(23)
    lay = params["stack"]["body"][0][0]
    d = cfg.d_model
    ones = torch.ones(d, device="cuda")
    ops = {
        "mean of squares over d_model, f32": (
            lambda x: x.square().mean(-1), torch.float32),
        "plain rmsnorm over d_model, f32": (
            lambda x: L.rmsnorm_apply({"scale": ones}, x), torch.float32),
        "norm kernel over d_model, f32": (
            lambda x: L.norm_apply(cfg, {"scale": ones}, x,
                                   use_kernels=True), torch.float32),
        "wq projection (cuBLAS), bf16": (
            lambda x: x @ lay["mixer"]["wq"], torch.bfloat16),
        "LM head (cuBLAS), bf16": (
            lambda x: x @ params["embed"].T, torch.bfloat16),
    }
    log("batch invariance: values of 16 rows together that differ from "
        "the rows alone (20 draws)")
    for name, (fn, dt) in ops.items():
        bad = total = 0
        for _ in range(20):
            x = torch.randn(ENGINE_SLOTS, 1, d, generator=gen,
                            device="cuda").to(dt)
            together = fn(x)
            alone = torch.cat([fn(x[i:i + 1]) for i in range(len(x))])
            bad += int((together != alone).sum())
            total += together.numel()
        log(f"  {name:<38} {bad} of {total}")


def engine_model(params):
    """qwen3-1.7b at full width with the depth cut to ENGINE_LAYERS: the
    config and the first layers of phase 7's parameters (no copy)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              body_repeats=ENGINE_LAYERS)
    stack = dict(params["stack"], body=[
        slot[:ENGINE_LAYERS] for slot in params["stack"]["body"]])
    return cfg, dict(params, stack=stack)


def phase_engine(params):
    """Phase 10: ContinuousEngine at full width, ENGINE_LAYERS of qwen3's
    28 layers (see the module doc). Returns its measurements."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serving import (ContinuousEngine, generate,
                                     poisson_trace, run_static_trace)
    cfg, params = engine_model(params)
    L = cfg.n_layers
    trace = poisson_trace(cfg, **ENGINE_TRACE)
    kw = dict(num_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
              layout="paged", page_size=ENGINE_PAGE)
    log(f"engine {SERVE_ARCH} bf16, {L} of 28 layers: {kw}, default pool; "
        f"trace {ENGINE_TRACE}: {sum(r.max_new_tokens for r in trace)} "
        f"tokens asked for")

    def instrument(eng, rec):
        step, admit = eng.step, eng._admit

        def counted_step():
            rec["pos"].append(eng.pos.copy())
            before = FD.launches["flash_decode"]
            step()
            rec["decode_flash_decode"] += FD.launches["flash_decode"] - before

        def counted_admit(req, slot):
            fa = FA.launches["flash_attention"]
            ok = admit(req, slot)
            if ok:
                rec["admits"].append((req.id, slot, slot in rec["used"],
                                      FA.launches["flash_attention"] - fa))
                rec["used"].add(slot)
            return ok

        eng.step, eng._admit = counted_step, counted_admit

    out = {}
    runs = {}
    for cache_dtype in (None, "int8"):
        eng = ContinuousEngine(params, cfg, cache_dtype=cache_dtype, **kw)
        rec = {"pos": [], "admits": [], "used": set(),
               "decode_flash_decode": 0}
        instrument(eng, rec)
        label = cache_dtype or "bf16"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_serving_launches()
        t0 = time.perf_counter()
        with admission_logits() as prefill_logits:
            comps = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = serving_launches()
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        pbytes = pool_bytes(eng.cache)
        log(f"  {label} pool ({pbytes / 1e9:.3f} GB over {L} layers): "
            f"{ {k: round(v, 3) for k, v in st.items()} }; wall "
            f"{wall:.2f} s; peak memory {peak:.2f} GiB; launches {launches}")
        toks = {i: c.tokens for i, c in comps.items()}
        runs[label] = toks
        bad = [r.id for r in trace if len(toks.get(r.id, ())) !=
               r.max_new_tokens or not all(0 <= t < cfg.vocab_size
                                           for t in toks[r.id])]
        if sorted(toks) != [r.id for r in trace] or bad:
            raise AssertionError(f"{label}: requests incomplete or out of "
                                 f"vocabulary: {bad}")
        steps = int(st["steps"])
        admits = rec["admits"]
        want = {"flash_decode_paged": L * steps, "flash_attention":
                L * len(trace)}
        got = {k: launches[k] for k in want}
        if got != want or rec["decode_flash_decode"] != 0 or \
                any(n != L for *_, n in admits):
            raise AssertionError(
                f"{label}: launches {got}, want {want}; flash_decode in "
                f"decode steps {rec['decode_flash_decode']}; flash_attention "
                f"an admission {sorted({n for *_, n in admits})}")
        # the bound over the run: every launch at its own step's positions
        work = [paged_work(p, cfg.n_kv_heads, cfg.n_heads, cfg.head_dim,
                           ENGINE_PAGE, 2, int8=cache_dtype == "int8")
                for p in rec["pos"]]
        out[label] = {"stats": st, "wall_s": wall, "peak_gib": peak,
                      "pool_bytes": pbytes, "launches": launches,
                      "bound": bound(L * sum(w[0] for w in work),
                                     L * sum(w[1] for w in work), BF16_FLOPS)}
        if cache_dtype is None:
            n = len(rec["pos"])
            out["states"] = [rec["pos"][(2 * i + 1) * n // (2 * PAGED_STATES)]
                             for i in range(PAGED_STATES)]
            out["admits"] = admits
            # phase 35's reference: each request's prefill logits
            out["prefill_logits"] = {
                i: lg.float().cpu().numpy()
                for (i, *_), lg in zip(admits, prefill_logits)}
        del eng
        gc.collect()        # the patched step holds a cycle with eng
        torch.cuda.empty_cache()

    # each pool once more, in the other order (bf16, int8, int8, bf16), so
    # each pool's tokens/s is read twice around the other's; then one run
    # of each under the profiler (the device's activity only): device ms
    # and launches by kernel family over the whole run
    for cache_dtype in ("int8", None):
        label = cache_dtype or "bf16"
        eng = ContinuousEngine(params, cfg, cache_dtype=cache_dtype, **kw)
        torch.cuda.synchronize()
        toks = {i: c.tokens for i, c in eng.run(trace).items()}
        torch.cuda.synchronize()
        st = eng.stats()
        if toks != runs[label]:
            raise AssertionError(f"{label}: a second run gave other tokens")
        out[label]["repeat_stats"] = st
        log(f"  {label} pool again: useful {st['useful_tok_s']:.1f} raw "
            f"{st['raw_tok_s']:.1f} tokens/s ({st['elapsed_s']:.2f} s)")
        del eng
        torch.cuda.empty_cache()
    for cache_dtype in (None, "int8"):
        label = cache_dtype or "bf16"
        # the profiler has lost a kernel event of a whole run (8,091 paged
        # kernels against the counter's 8,092): a run whose profile does not
        # hold every paged kernel is profiled once more, and the numbers
        # come only from a profile that holds them all
        for attempt in range(2):
            eng = ContinuousEngine(params, cfg, cache_dtype=cache_dtype,
                                   **kw)
            reset_serving_launches()
            busy, kernels = profile_device_ms(lambda: eng.run(trace),
                                              reps=1, warm=False, host=False,
                                              tries=1)
            fam, calls = by_family(kernels)
            paged = serving_launches()["flash_decode_paged"]
            if calls.get("flash_decode_paged") == paged:
                break
            msg = (f"{label}: the profile holds "
                   f"{calls.get('flash_decode_paged')} paged decode kernels,"
                   f" the counter {paged}")
            if attempt == 1:
                raise AssertionError(msg)
            log(f"  {msg}; profiling the run again")
            del eng
        elapsed = [out[label]["stats"]["elapsed_s"],
                   out[label]["repeat_stats"]["elapsed_s"]]
        out[label]["run_profile"] = {"busy_ms": busy or 0.0,
                                     "families": fam, "calls": calls}
        log(f"  {label} pool, profiled run: device busy {busy or 0.0:.1f} ms"
            f" (idle share {1 - (busy or 0.0) / 1e3 / (sum(elapsed) / 2):.3f}"
            f" of the unprofiled runs' {elapsed[0]:.2f} and {elapsed[1]:.2f}"
            f" s); device ms by family "
            f"{ {k: round(v, 3) for k, v in sorted(fam.items())} }; "
            f"launches a step by family "
            f"{ {k: round(v / eng.steps, 2) for k, v in sorted(calls.items())} }")
        del eng
        torch.cuda.empty_cache()

    same = sum(a == b for i in runs["bf16"]
               for a, b in zip(runs["bf16"][i], runs["int8"][i]))
    total = sum(len(t) for t in runs["bf16"].values())
    out["int8_agreement"] = same / total
    log(f"  int8 pool vs bf16 pool: {same} of {total} tokens agree "
        f"({same / total:.4f}); pool bytes "
        f"{out['int8']['pool_bytes'] / out['bf16']['pool_bytes']:.4f} of "
        f"bf16's")

    # four requests against their solo runs
    admits = out["admits"]
    by_id = {r.id: r for r in trace}
    recycled = next(i for i, _, reused, _ in admits if reused)
    long = next(i for i, *_ in admits if len(by_id[i].prompt) == 512
                and i not in (admits[0][0], recycled))
    chosen = {"first admitted": admits[0][0],
              "admitted into a recycled slot": recycled,
              "512-token prompt": long, "last admitted": admits[-1][0]}
    for why, i in chosen.items():
        r = by_id[i]
        solo = generate(params, cfg, np.asarray(r.prompt)[None],
                        max_new_tokens=r.max_new_tokens)
        solo = solo[0, len(r.prompt):].tolist()
        eq = solo == runs["bf16"][i]
        log(f"  request {i} ({why}, prompt {len(r.prompt)}, "
            f"{r.max_new_tokens} tokens) alone: "
            f"{'equal' if eq else 'DIFFERENT'}")
        if not eq:
            d, gap = solo_divergence(params, cfg, r.prompt, solo,
                                     runs["bf16"][i])
            log(f"  first divergence of request {i} at generated token {d}; "
                f"top-2 logit gap of the solo run there {gap:.4g}")
            raise AssertionError(f"request {i} differs from its solo run")

    # one profiled decode step with the 16 slots busy, for each pool
    for cache_dtype in (None, "int8"):
        label = cache_dtype or "bf16"
        eng = ContinuousEngine(params, cfg, cache_dtype=cache_dtype, **kw)
        step = eng.step
        prof = {}

        def profiled_step():
            if eng.steps == 8:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                prof["host_ms"] = (time.perf_counter() - t0) * 1e3
            elif eng.steps == 9:
                prof["busy"], prof["kernels"] = profile_device_ms(step,
                                                                  reps=1)
                raise _Stop
            else:
                step()

        eng.step = profiled_step
        try:
            eng.run([dataclasses.replace(r, arrival=0.0)
                     for r in trace[:16]])
        except _Stop:
            pass
        fam, calls = by_family(prof["kernels"])
        busy, host_ms = prof["busy"] or 0.0, prof["host_ms"]
        out[label]["profile"] = {"host_ms": host_ms, "busy_ms": busy,
                                 "families": fam, "calls": calls}
        log(f"  profile engine decode step ({label} pool, 16 active rows): "
            f"device ms by family "
            f"{ {k: round(v, 3) for k, v in sorted(fam.items())} }; "
            f"launches by family {dict(sorted(calls.items()))} "
            f"({sum(calls.values())}); busy {busy:.3f} ms of a "
            f"{host_ms:.3f} ms step (idle share {1 - busy / host_ms:.3f})")
        for t, count, name in sorted(prof["kernels"], reverse=True)[:8]:
            log(f"    {t:9.3f} ms  x{count:<4d} {name[:80]}")
        del eng
        gc.collect()        # the patched step holds a cycle with eng
        torch.cuda.empty_cache()

    # the lockstep baseline on the same trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    useful = run_static_trace(params, cfg, trace, batch=ENGINE_SLOTS,
                              max_len=ENGINE_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["static"] = {"useful_tokens": useful, "wall_s": wall,
                     "useful_tok_s": useful / wall}
    log(f"  run_static_trace (batch {ENGINE_SLOTS}, lockstep): {useful} "
        f"useful tokens in {wall:.2f} s = {useful / wall:.1f} useful "
        f"tokens/s; continuous engine {out['bf16']['stats']['useful_tok_s']:.1f}")
    torch.cuda.empty_cache()
    out["tokens"] = runs
    return out


@contextlib.contextmanager
def admission_logits():
    """Every admission prefill's last-position logits (1 row each, a
    device copy: no wait on the card) in admission order, while inside."""
    from repro_torch.serving import engine as E
    base, seen = E.prefill_fused, []

    def recording(*args, **kwargs):
        last, cache = base(*args, **kwargs)
        seen.append(last[0].detach().clone())
        return last, cache

    E.prefill_fused = recording
    try:
        yield seen
    finally:
        E.prefill_fused = base


def phase_engine_cuda_vs_cpu():
    """Phase 11: reduced qwen3 in f32 through ContinuousEngine on the card
    (kernels) and on the CPU (plain versions), from the same parameters,
    on a trace that forces slot reuse: equal completions, for the
    full-precision and the int8 pool."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import ContinuousEngine, poisson_trace
    cfg = dataclasses.replace(get_config(SERVE_ARCH + "-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(3, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    trace = poisson_trace(cfg, 8, rate=0.7, prompt_len_choices=(5, 16, 40),
                          new_token_choices=(4, 12), seed=2)
    for cache_dtype in (None, "int8"):
        kw = dict(num_slots=3, max_len=64, layout="paged", page_size=8,
                  cache_dtype=cache_dtype)
        runs = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            eng = ContinuousEngine(p, cfg, device=dev, **kw)
            runs[dev] = {i: c.tokens for i, c in eng.run(trace).items()}
        same = runs["cuda"] == runs["cpu"] and len(runs["cuda"]) == 8
        log(f"engine cuda vs cpu: {cfg.name} f32, 8 requests through 3 "
            f"slots, pool {cache_dtype or 'f32'}: completions "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("engine completions differ between cuda "
                                 "and cpu")


def paged_row(err, engine, timing):
    """The flash_decode_paged JSON row, per bf16 engine run: ms is the
    kernel's device time over a profiled run of the engine (every launch
    of the run); plain and library ms are their per-call times at the
    states sampled across the run (cold pools, medians of rounds),
    averaged over the states and times the run's launches; the bound sums
    the bytes and operations of every launch at its own step's
    positions."""
    run = engine["bf16"]
    n = run["launches"]["flash_decode_paged"]

    def per_run(key):
        vals = [t[key] for t in timing]
        return None if None in vals else sum(vals) / len(vals) * n

    return {"name": "flash_decode_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
            "replaces": PAGED_REPLACES, "launches": n, "max_abs_err": err,
            "ms": run["run_profile"]["families"]["flash_decode_paged"],
            "plain_ms": per_run("plain_ms"), "bound_ms": run["bound"][0],
            "bound_by": run["bound"][1], "library_ms": per_run("library_ms")}


def serving_rows(kern, serve):
    """One JSON row per serving kernel, totalled over one generate: each
    kernel's per-call device times at the run's shapes times its calls; the
    bound is the sum over the run's parts (prefill calls, decode calls) of
    each part's own bound from its bytes and operations."""
    from repro_torch.configs import get_config
    L, steps = get_config(SERVE_ARCH).n_layers, SERVE_NEW - 1
    rows = []
    for name, (src, replaces) in SERVE_KERNELS.items():
        k = kern[name]
        if name == "rmsnorm_residual":
            # a forward pass: L fused residual norms, and L + 1 norms with
            # no residual (each layer's pre-attention norm, the final norm)
            parts = [(k[SERVE_B * SERVE_P], L),
                     (k[(SERVE_B * SERVE_P, "no residual")], L + 1),
                     (k[SERVE_B], L * steps),
                     (k[(SERVE_B, "no residual")], (L + 1) * steps)]
        elif name == "swiglu":
            parts = [(k[SERVE_B * SERVE_P], L), (k[SERVE_B], L * steps)]
        elif name == "flash_attention":
            parts = [(k[SERVE_P], L)]
        else:   # mean of the first and last decode positions, every step
            parts = [(k[SERVE_P], L * steps / 2),
                     (k[SERVE_P + SERVE_NEW - 2], L * steps / 2)]
        tot = {f: sum(r[f] * c for r, c in parts) for f in ("ms", "plain_ms")}
        # each part (prefill, decode) bound by its own resource; the row's
        # bound is their sum, named by the part that contributes most
        part_bounds = [(bound(r["work"][0] * c, r["work"][1] * c,
                              r["work"][2])) for r, c in parts]
        bms = sum(b for b, _ in part_bounds)
        by = max(part_bounds)[1]
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


# ---------------------------------------------------------------------------
# LM training: qwen3-1.7b make_lm_train_step (B4, B6, B7, B8, and the
# forward kernels B3, B5 under their autograd Functions)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T = 8, 512            # rows of token_lm, 4096 tokens a step
TRAIN_STEPS = 5                      # timed, after one warm step
TRAIN_SEED = 5
TRAIN_LR = 0.5
TRAIN_KERNELS = {
    # name: (source, TPU kernel it replaces, tolerance of its small f32
    # check (the reference tests' own: tests/test_fused_kernels.py,
    # tests/test_kernels.py), profiler family of its kernels, kernels one
    # bf16 wrapper call launches)
    "rmsnorm_residual_backward": ("rmsnorm_residual.cu",
                                  "src/repro/kernels/fused_norm.py:105",
                                  1e-5, "rmsnorm_residual_bwd", 2),
    "swiglu_backward": ("swiglu_bwd.cu", "src/repro/kernels/swiglu.py:115",
                        1e-4, "swiglu_bwd", 2),
    "flash_attention_rope": ("flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:278",
                             2e-5, "flash_fwd", 2),
    "flash_attention_backward": ("flash_attention_bwd.cu",
                                 "src/repro/kernels/flash_attention.py:509",
                                 5e-4, "flash_bwd", 3),
}


def norm_bwd_work(N, d, esize=2, residual=True):
    # read s, dy (and ds), scale; write dx, dscale; ~10 f32 ops an element
    return (esize * (4 if residual else 3) * N * d + 8 * d, 10.0 * N * d,
            F32_FLOPS)


def swiglu_bwd_work(N, d, F, esize=2):
    # read x, wg, wu, g, dh; write dg, du and dx (f32); the recompute
    # u = x wu and dx = dg wg^T + du wu^T: three products of 2 N d F
    return (esize * (N * d + 2 * d * F + 4 * N * F) + 4 * N * d,
            6.0 * N * d * F, BF16_FLOPS)


def causal_pairs(B, T):
    return B * T * (T + 1) // 2


def attn_rope_work(B, H, KV, T, hd, esize=2):
    # read q, k, v, pos; write o, lse; QK^T and PV over the causal pairs
    nbytes = esize * (2 * B * H * T * hd + 2 * B * KV * T * hd) \
        + 4 * B * T + 4 * B * H * T
    return nbytes, 4.0 * hd * H * causal_pairs(B, T), BF16_FLOPS


def attn_bwd_work(B, H, KV, T, hd, esize=2):
    # read q, o, do, k, v, lse; write dq, dk, dv; five products over the
    # causal pairs (q k^T, do v^T, p^T do, ds k, ds^T q)
    nbytes = esize * (4 * B * H * T * hd + 4 * B * KV * T * hd) \
        + 4 * B * H * T
    return nbytes, 10.0 * hd * H * causal_pairs(B, T), BF16_FLOPS


def phase_train_kernels():
    """Phase 12: each training kernel against its plain version on the
    card, at the full-width shapes of the train step in bf16 (BF16_TOL) and
    at small f32 shapes (the reference's tolerances), with ragged T, a
    window, GQA and the norm without a residual; each autograd Function's
    gradients against plain autograd through the plain forward (f32); device
    times of kernel, plain version and one library call, and the bound, at
    the step's shapes. Returns {name: {"err": .., key: row}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swiglu as SW
    cfg = get_config(SERVE_ARCH)
    d, Fh, H, KV, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    B, T = TRAIN_B, TRAIN_T
    N = B * T
    theta = cfg.rope_theta
    gen = torch.Generator(device="cuda").manual_seed(13)
    randn = lambda *s, dt=torch.bfloat16, sc=1.0: (  # noqa: E731
        sc * torch.randn(*s, generator=gen, device="cuda")).to(dt)
    out = {k: {"err": 0.0} for k in TRAIN_KERNELS}

    def record(name, label, got, want, tol):
        e = check_close(f"{name} {label}", got.float(), want.float(), tol)
        out[name]["err"] = max(out[name]["err"], e)

    def record_sum(name, label, got, want, tol):
        e = check_sum(f"{name} {label}", got, want, tol)
        out[name]["err"] = max(out[name]["err"], e)

    def timed(name, key, kern, plain, library, work):
        # CUDA events: in these isolated calls the profiler dropped kernels
        # (swiglu_backward once read 2.4 ms, above the f32 FMA peak, and
        # SDPA's forward below its byte bound)
        out[name][key] = time_row(name, key, kern, plain, library, work,
                                  timer=time_ms)

    def positions(Bq, Tq):
        return (torch.arange(Tq, device="cuda")[None]
                + 3 * torch.arange(Bq, device="cuda")[:, None]).float()

    # B4: rmsnorm_residual backward ------------------------------------------
    name = "rmsnorm_residual_backward"
    tol32 = TRAIN_KERNELS[name][2]
    log(f"kernel check {name}")
    scale = torch.linspace(0.5, 1.5, d, device="cuda")
    s, dy, ds = (randn(N, d) for _ in range(3))
    def graph(s_, dy_):
        # F.rms_norm's forward, whose backward is timed again and again
        sg = s_.detach().requires_grad_(True)
        wg_ = scale.bfloat16().requires_grad_(True)
        return F.rms_norm(sg, (d,), wg_, 1e-6), sg, wg_, dy_

    for key, dsv in (("residual", ds), ("no residual", None)):
        dx, dsc = FN.rmsnorm_residual_backward(s, scale, dy, dsv)
        rdx, rdsc = ref.rmsnorm_residual_backward_ref(s, scale, dy, dsv)
        record(name, f"({N}, {d}) bf16 {key} dx", dx, rdx, BF16_TOL)
        record_sum(name, f"({N}, {d}) bf16 {key} dscale", dsc, rdsc,
                   BF16_TOL)
        # queued CUDA events: the wrapper's host time is more than the
        # kernels' at this shape
        ins = input_copies(s, dy, *(() if dsv is None else (dsv,)))
        graphs = [graph(s_, dy_) for s_, dy_, *_ in ins]
        out[name][key] = time_row(
            name, key,
            rotating(lambda s_, dy_, ds_=None: FN.rmsnorm_residual_backward(
                s_, scale, dy_, ds_), ins),
            rotating(lambda s_, dy_, ds_=None:
                     ref.rmsnorm_residual_backward_ref(s_, scale, dy_, ds_),
                     ins),
            rotating(lambda yl, sg, wg_, dy_: torch.autograd.grad(
                yl, (sg, wg_), dy_, retain_graph=True), graphs),
            norm_bwd_work(N, d, residual=dsv is not None), timer=queued_ms)
        del ins, graphs
    # a decode-sized call's device time (profiler)
    s8, dy8, ds8 = (randn(8, d) for _ in range(3))
    sg8 = s8.detach().requires_grad_(True)
    wg8 = scale.bfloat16().requires_grad_(True)
    yl8 = F.rms_norm(sg8, (d,), wg8, 1e-6)
    out[name]["(8, 2048)"] = time_row(
        name, (8, d), lambda: FN.rmsnorm_residual_backward(s8, scale, dy8, ds8),
        lambda: ref.rmsnorm_residual_backward_ref(s8, scale, dy8, ds8),
        lambda: torch.autograd.grad(yl8, (sg8, wg8), dy8, retain_graph=True),
        norm_bwd_work(8, d))
    # small f32 shapes, widths off the 16-byte chunk, the stream body (f32
    # rows past 4096) and an unaligned view (the scalar path)
    flat = randn(3 * 4 * 256 + 1)
    views = tuple(flat[1 + 1024 * i:1 + 1024 * (i + 1)].view(4, 256)
                  for i in range(3))
    for (n_, d_), res in (((17, 128), True), ((33, 256), False),
                          ((5, 100), True), ((300, 7), True),
                          ((300, 7), False), ((64, 8192), True),
                          ((64, 8192), False), ((4, 256), True)):
        if (n_, d_) == (4, 256):
            s2, dy2, ds2 = views
            sc2, tol = scale[:256], BF16_TOL
            label = "(4, 256) bf16 unaligned views"
        else:
            s2, dy2, ds2 = (randn(n_, d_, dt=torch.float32)
                            for _ in range(3))
            sc2, tol = torch.linspace(0.5, 1.5, d_, device="cuda"), tol32
            label = f"({n_}, {d_}) f32{'' if res else ' no residual'}"
        ds2 = ds2 if res else None
        got = FN.rmsnorm_residual_backward(s2, sc2, dy2, ds2)
        want = ref.rmsnorm_residual_backward_ref(s2, sc2, dy2, ds2)
        record(name, label + " dx", got[0], want[0], tol)
        record_sum(name, label + " dscale", got[1], want[1], tol)
    # the stream body at a train step's rows, by CUDA events
    s2, dy2, ds2 = (randn(N, 8192, dt=torch.float32) for _ in range(3))
    sc2 = torch.linspace(0.5, 1.5, 8192, device="cuda")
    ms = queued_ms(rotating(
        lambda s_, dy_, ds_: FN.rmsnorm_residual_backward(s_, sc2, dy_, ds_),
        input_copies(s2, dy2, ds2)), reps=20)
    out[name]["stream (4096, 8192) f32"] = ms
    log(f"  {name} ({N}, 8192) f32 (stream body): {ms:.4f} ms a call "
        f"(events), bound {bound(*norm_bwd_work(N, 8192, esize=4))[0]:.4f}")
    del s, dy, ds, s2, dy2, ds2, s8, dy8, ds8, sg8, wg8, yl8, flat, views
    out[name]["widths"] = norm_widths(True, record, record_sum)

    # B6: swiglu backward ------------------------------------------------------
    name = "swiglu_backward"
    log(f"kernel check {name}")
    x = randn(N, d)
    wg, wu = randn(d, Fh, sc=d ** -0.5), randn(d, Fh, sc=d ** -0.5)
    dh = randn(N, Fh)
    g = ref.swiglu_ref(x, wg, wu)[1]
    got = SW.swiglu_backward(x, wg, wu, g, dh)
    want = ref.swiglu_backward_ref(x, wg, wu, g, dh)
    for lab, a, b in zip(("dx", "dg", "du"), got, want):
        record(name, f"({N}, {d}->{Fh}) bf16 {lab}", a, b, BF16_TOL)
    del got, want

    def swiglu_library():
        # the three cuBLAS products and the elementwise part, in bf16
        u = x @ wu
        sig = torch.sigmoid(g)
        du_ = dh * g * sig
        dg_ = dh * u * sig * (1 + g * (1 - sig))
        return dg_ @ wg.T + du_ @ wu.T

    timed(name, N, lambda: SW.swiglu_backward(x, wg, wu, g, dh),
          lambda: ref.swiglu_backward_ref(x, wg, wu, g, dh), swiglu_library,
          swiglu_bwd_work(N, d, Fh))
    check_rows_solo(name, SW.swiglu_backward, (x, wg, wu, g, dh), (0, 3, 4),
                    INVARIANT_ROWS)
    x2 = randn(33, 256, dt=torch.float32)
    w1, w2 = (randn(256, 384, dt=torch.float32, sc=1 / 16) for _ in range(2))
    dh2 = randn(33, 384, dt=torch.float32)
    g2 = ref.swiglu_ref(x2, w1, w2)[1]
    for lab, a, b in zip(("dx", "dg", "du"),
                         SW.swiglu_backward(x2, w1, w2, g2, dh2),
                         ref.swiglu_backward_ref(x2, w1, w2, g2, dh2)):
        record(name, f"(33, 256->384) f32 {lab}", a, b,
               TRAIN_KERNELS[name][2])
    del x, wg, wu, dh, g

    # B7: RoPE flash attention forward -----------------------------------------
    name = "flash_attention_rope"
    log(f"kernel check {name}")
    q = randn(B, H, T, hd)
    k, v = randn(B, KV, T, hd), randn(B, KV, T, hd)
    pos = torch.arange(T, device="cuda").float()[None].expand(B, T) \
        .contiguous()
    o, lse = FA.flash_attention_rope_fwd(q, k, v, pos, theta=theta,
                                         return_lse=True)
    ro, rlse = ref.attention_rope_ref(q, k, v, pos, theta=theta,
                                      return_lse=True)
    record(name, f"B={B} H={H} KV={KV} T={T} hd={hd} causal bf16 o", o, ro,
           BF16_TOL)
    record(name, "  the same, lse", lse, rlse, BF16_TOL)
    qr, kr = ref.rope_rotate_hm(q, pos, theta), ref.rope_rotate_hm(k, pos,
                                                                   theta)
    timed(name, T,
          lambda: FA.flash_attention_rope_fwd(q, k, v, pos, theta=theta,
                                              return_lse=True),
          lambda: ref.attention_rope_ref(q, k, v, pos, theta=theta,
                                         return_lse=True),
          lambda: F.scaled_dot_product_attention(qr, kr, v, is_causal=True,
                                                 enable_gqa=True),
          attn_rope_work(B, H, KV, T, hd))
    # beside it, the attention kernel alone on pre-rotated q, k (B9's body)
    timed(name, (T, "no RoPE"),
          lambda: FA.flash_attention_fwd(qr, kr, v, return_lse=True),
          lambda: ref.attention_ref(qr, kr, v, return_lse=True),
          lambda: F.scaled_dot_product_attention(qr, kr, v, is_causal=True,
                                                 enable_gqa=True),
          attn_rope_work(B, H, KV, T, hd))
    for (b_, h_, kv_, t_, hd_), window in (((2, 4, 2, 100, 64), 13),
                                           ((1, 2, 2, 17, 32), None),
                                           ((1, 8, 2, 130, 128), None)):
        qs = randn(b_, h_, t_, hd_, dt=torch.float32)
        ks_, vs_ = (randn(b_, kv_, t_, hd_, dt=torch.float32)
                    for _ in range(2))
        ps = positions(b_, t_)
        go, gl = FA.flash_attention_rope_fwd(qs, ks_, vs_, ps, theta=1e4,
                                             window=window, return_lse=True)
        wo, wl = ref.attention_rope_ref(qs, ks_, vs_, ps, theta=1e4,
                                        window=window, return_lse=True)
        label = f"({b_}, {h_}, {kv_}, {t_}, {hd_}) f32 window {window}"
        record(name, label + " o", go, wo, TRAIN_KERNELS[name][2])
        record(name, label + " lse", gl, wl, TRAIN_KERNELS[name][2])
    for (b_, h_, kv_, t_, hd_), causal, window, _ in FLASH_EDGES:
        qe = randn(b_, h_, t_, hd_)
        ke, ve = randn(b_, kv_, t_, hd_), randn(b_, kv_, t_, hd_)
        pe = positions(b_, t_)
        dts = [(torch.bfloat16, BF16_TOL)] + (
            [(torch.float32, TRAIN_KERNELS[name][2])]
            if hd_ in WIDE_HEAD_DIMS else [])
        for dt, tol in dts:
            qd, kd, vd = (t.to(dt) for t in (qe, ke, ve))
            go, gl = FA.flash_attention_rope_fwd(qd, kd, vd, pe, theta=1e4,
                                                 causal=causal,
                                                 window=window,
                                                 return_lse=True)
            wo, wl = ref.attention_rope_ref(qd, kd, vd, pe, theta=1e4,
                                            causal=causal, window=window,
                                            return_lse=True)
            label = (f"({b_}, {h_}, {kv_}, {t_}, {hd_}) {str(dt)[6:]} "
                     f"causal {causal} window {window}")
            record(name, label + " o", go, wo, tol)
            # in bf16 the kernel rounds the rotated q and k to bf16, the
            # plain version keeps them in f32: lse within BF16_TOL there
            record(name, label + " lse", gl, wl, tol)

    # B8: flash attention backward ---------------------------------------------
    name = "flash_attention_backward"
    tol32 = TRAIN_KERNELS[name][2]
    log(f"kernel check {name}")
    do = randn(B, H, T, hd)
    o, lse = ref.attention_ref(qr, kr, v, return_lse=True)
    got = FA.flash_attention_backward(qr, kr, v, o, lse, do)
    want = ref.attention_backward_ref(qr, kr, v, o, lse, do)
    for lab, a, b in zip(("dq", "dk", "dv"), got, want):
        record(name, f"B={B} H={H} KV={KV} T={T} hd={hd} causal bf16 {lab}",
               a, b, BF16_TOL)
    again = FA.flash_attention_backward(qr, kr, v, o, lse, do)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two calls differ")
    log("  two calls on the same inputs: equal bits")
    del got, want, again

    def rope_bwd_plain(q_, k_, v_, p_, o_, l_, do_, theta_, **kw):
        # the composite plain version: rotate, plain backward, rotate back
        dq_, dk_, dv_ = ref.attention_backward_ref(
            ref.rope_rotate_hm(q_, p_, theta_),
            ref.rope_rotate_hm(k_, p_, theta_), v_, o_, l_, do_, **kw)
        return (ref.rope_rotate_hm(dq_, -p_, theta_),
                ref.rope_rotate_hm(dk_, -p_, theta_), dv_)

    # the RoPE backward the train step runs: one launch on unrotated q, k
    o, lse = FA.flash_attention_rope_fwd(q, k, v, pos, theta=theta,
                                         return_lse=True)
    got = FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                           theta=theta)
    want = rope_bwd_plain(q, k, v, pos, o, lse, do, theta)
    for lab, a, b in zip(("dq", "dk", "dv"), got, want):
        record(name, f"B={B} H={H} KV={KV} T={T} hd={hd} causal bf16 RoPE "
               f"{lab}", a, b, BF16_TOL)
    again = FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                             theta=theta)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two RoPE calls differ")
    log("  two RoPE calls on the same inputs: equal bits")
    del got, want, again
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (qr, kr, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                        enable_gqa=True)
    timed(name, T,
          lambda: FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                                   theta=theta),
          lambda: rope_bwd_plain(q, k, v, pos, o, lse, do, theta),
          lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                      retain_graph=True),
          attn_bwd_work(B, H, KV, T, hd))
    # beside it, the RoPE-free kernel (flash_attention_hm's backward)
    timed(name, (T, "no RoPE"),
          lambda: FA.flash_attention_backward(qr, kr, v, o, lse, do),
          lambda: ref.attention_backward_ref(qr, kr, v, o, lse, do),
          lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                      retain_graph=True),
          attn_bwd_work(B, H, KV, T, hd))
    del ql, kl, vl, ol, q, k, v, qr, kr, o, lse, do
    for (b_, h_, kv_, t_, hd_), causal, window, _ in FLASH_EDGES:
        if hd_ not in FA.BWD_HEAD_DIMS:
            continue
        qe, doe = randn(b_, h_, t_, hd_), randn(b_, h_, t_, hd_)
        ke, ve = randn(b_, kv_, t_, hd_), randn(b_, kv_, t_, hd_)
        pe = positions(b_, t_)
        label = (f"({b_}, {h_}, {kv_}, {t_}, {hd_}) causal {causal} window "
                 f"{window}")
        oe, le = ref.attention_ref(qe, ke, ve, causal=causal, window=window,
                                   return_lse=True)
        got = FA.flash_attention_backward(qe, ke, ve, oe, le, doe,
                                          causal=causal, window=window)
        want = ref.attention_backward_ref(qe, ke, ve, oe, le, doe,
                                          causal=causal, window=window)
        for lab, a, b in zip(("dq", "dk", "dv"), got, want):
            record(name, f"{label} bf16 {lab}", a, b, BF16_TOL)
        again = FA.flash_attention_backward(qe, ke, ve, oe, le, doe,
                                            causal=causal, window=window)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} {label}: two calls differ")
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, tol32)):
            qd, kd, vd, dod = (t.to(dt) for t in (qe, ke, ve, doe))
            od, ld = ref.attention_rope_ref(qd, kd, vd, pe, theta=1e4,
                                            causal=causal, window=window,
                                            return_lse=True)
            for lab, a, b in zip(
                    ("dq", "dk", "dv"),
                    FA.flash_attention_rope_backward(
                        qd, kd, vd, pe, od, ld, dod, theta=1e4,
                        causal=causal, window=window),
                    rope_bwd_plain(qd, kd, vd, pe, od, ld, dod, 1e4,
                                   causal=causal, window=window)):
                record(name, f"{label} RoPE {str(dt)[6:]} {lab}", a, b, tol)
    for (b_, h_, kv_, t_, hd_), causal, window in (
            ((2, 4, 2, 100, 64), True, 13), ((1, 8, 1, 128, 64), False, None),
            ((1, 2, 2, 17, 32), True, None), ((1, 4, 2, 130, 128), True,
                                              None),
            ((2, 8, 2, 100, 120), True, 13), ((1, 4, 1, 130, 112), True,
                                              None)):
        qs, dos = (randn(b_, h_, t_, hd_, dt=torch.float32)
                   for _ in range(2))
        ks_, vs_ = (randn(b_, kv_, t_, hd_, dt=torch.float32)
                    for _ in range(2))
        os_, ls_ = ref.attention_ref(qs, ks_, vs_, causal=causal,
                                     window=window, return_lse=True)
        label = (f"({b_}, {h_}, {kv_}, {t_}, {hd_}) f32 causal {causal} "
                 f"window {window}")
        for lab, a, b in zip(
                ("dq", "dk", "dv"),
                FA.flash_attention_backward(qs, ks_, vs_, os_, ls_, dos,
                                            causal=causal, window=window),
                ref.attention_backward_ref(qs, ks_, vs_, os_, ls_, dos,
                                           causal=causal, window=window)):
            record(name, f"{label} {lab}", a, b, tol32)

    # the autograd Functions against plain autograd of the plain forward ------
    log("autograd Functions vs plain autograd (f32)")

    def grads(fn, inputs, cots):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(
            sum((a * c).sum() for a, c in zip(outs, cots)), leaves)

    def check_fn(name, label, kern, plain, inputs, cots):
        for i, (a, b) in enumerate(zip(grads(kern, inputs, cots),
                                       grads(plain, inputs, cots))):
            record(name, f"Function {label} grad {i}", a, b,
                   TRAIN_KERNELS[name][2])

    xa, ra, dya, dsa = (randn(33, 256, dt=torch.float32) for _ in range(4))
    sca = torch.linspace(0.5, 1.5, 256, device="cuda")
    check_fn("rmsnorm_residual_backward", "rmsnorm_residual",
             lambda a, b, c: ops.rmsnorm_residual(a, b, c),
             lambda a, b, c: ref.rmsnorm_residual_ref(a, b, c),
             (xa, ra, sca), (dya, dsa))
    check_fn("rmsnorm_residual_backward", "rmsnorm (no residual)",
             lambda a, c: ops.rmsnorm_residual(a, None, c)[0],
             lambda a, c: ref.rmsnorm_residual_ref(a, None, c)[0],
             (xa, sca), (dya,))
    wa, wb = (randn(256, 384, dt=torch.float32, sc=1 / 16) for _ in range(2))
    check_fn("swiglu_backward", "swiglu", ops.swiglu,
             lambda a, b, c: ref.swiglu_ref(a, b, c)[0], (xa, wa, wb),
             (randn(33, 384, dt=torch.float32),))
    qa, doa = (randn(2, 100, 4, 64, dt=torch.float32) for _ in range(2))
    ka, va = (randn(2, 100, 2, 64, dt=torch.float32) for _ in range(2))
    pa = positions(2, 100)
    check_fn("flash_attention_backward", "flash_attention_rope window 13",
             lambda a, b, c: ops.flash_attention_rope(a, b, c, pa, theta=1e4,
                                                      window=13),
             lambda a, b, c: ref.attention_rope_ref(
                 a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), pa,
                 theta=1e4, window=13).transpose(1, 2),
             (qa, ka, va), (doa,))
    check_fn("flash_attention_backward", "flash_attention (no offsets)",
             lambda a, b, c: ops.flash_attention(a, b, c),
             lambda a, b, c: ref.attention_ref(
                 a.transpose(1, 2), b.transpose(1, 2),
                 c.transpose(1, 2)).transpose(1, 2),
             (qa, ka, va), (doa,))
    torch.cuda.empty_cache()
    return out


def train_steps(label, cfg, params, batch, want, profiled=None,
                by_op=None, spans=contextlib.nullcontext, aux_key=None):
    """One warm and TRAIN_STEPS timed steps of make_lm_train_step
    (use_kernels, momentum SGD at TRAIN_LR, clip 1.0, f32 momentum) on the
    repeated ``batch`` (B=8 x T=512), as phases 13, 17, 23, 26 and 28 take
    them: the second step's launch counters must equal ``want``, the loss
    must be finite and fall; a profiled step (``by_op``, inside
    ``spans()``) must hold ``profiled``'s kernels ({counter: (family,
    kernels a launch)}, TRAIN_KERNELS' by default) as the counters say
    (late in a run the profiler has lost a window's first events, so a
    window that lost some is profiled again, three at most; it repeats the
    last step, from that step's input); a remat step from the last step's
    input must give the same loss and parameters within BF16_TOL.
    ``aux_key`` names a step metric collected beside the loss. Returns the
    measurements."""
    import torch
    from repro_torch import tree
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_lm_train_step
    lb = LargeBatchConfig(batch_size=TRAIN_B, base_batch_size=TRAIN_B,
                          grad_clip=1.0)
    regime = Regime(base_lr=TRAIN_LR, total_steps=100, drop_every=100)
    step_fn = make_lm_train_step(cfg, lb, regime, use_kernels=True)
    state = (params, sgd.init(params))
    del params
    losses, auxes, times, launches = [], [], [], None
    for i in range(1 + TRAIN_STEPS):
        if i == 1:      # only this step's input state is held here
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_all_launches()
        if i == TRAIN_STEPS:
            prev = state        # the last step's input, for the remat step
        t0 = time.perf_counter()
        p2, o2, m = step_fn(*state, batch, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            launches = all_launches()
        losses.append(m["loss"])
        if aux_key is not None:
            auxes.append(m[aux_key])
        state = (p2, o2)
    peak_bytes = torch.cuda.max_memory_allocated()
    peak, step_peak = peak_bytes / 2 ** 30, (peak_bytes - base) / 2 ** 30
    losses = torch.stack(losses).tolist()
    auxes = torch.stack(auxes).tolist() if auxes else []
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    tok_s = TRAIN_B * TRAIN_T / step_ms * 1e3
    log(f"  train {label} bf16 B={TRAIN_B} T={TRAIN_T} lr {TRAIN_LR}: step "
        f"ms {[round(t, 1) for t in times]} (first is the warm step), median "
        f"{step_ms:.1f} ms, {tok_s:.0f} tokens/s, peak memory {peak:.2f} GiB "
        f"({step_peak:.2f} above the step's input state); losses "
        f"{[round(x, 4) for x in losses]}; "
        + (f"{aux_key} {[round(x, 4) for x in auxes]}; " if aux_key else "")
        + f"launches a step {launches}")
    if launches != want:
        raise AssertionError(f"train launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses + auxes) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    # the last step's momentum goes before the profiled and remat steps,
    # which both take the last step's input again: the card then holds
    # that input state, the last step's parameters and one step's work
    # (h2o-danube-3-4b's 24 layers do not fit beside a second state)
    state = state[0]
    del p2, o2
    gc.collect()
    torch.cuda.empty_cache()
    if profiled is None:
        profiled = {name: tuple(k[3:]) for name, k in TRAIN_KERNELS.items()}
    want_calls = {fam: per_call * launches[name]
                  for name, (fam, per_call) in profiled.items()}
    for attempt in range(3):
        with spans():
            prof = family_profile("train step", lambda: step_fn(
                *prev, batch, TRAIN_STEPS), by_op=by_op)
        got = {fam: prof["calls"].get(fam, 0) for fam in want_calls}
        if got == want_calls:
            break
        log(f"  the profiled step holds {got} training kernels, the "
            f"counters {want_calls}")
    else:
        raise AssertionError("three profiled steps lost kernel events")

    gc.collect()
    torch.cuda.empty_cache()
    remat_fn = make_lm_train_step(cfg, lb, regime, use_kernels=True,
                                  remat=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # also holds the last output
    rp, _, rm = remat_fn(*prev, batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    remat_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    diff, bad, equal = 0.0, [], True
    for i, (a, b) in enumerate(zip(tree.leaves(rp), tree.leaves(state))):
        equal = equal and torch.equal(a, b)
        a, b = a.float(), b.float()
        diff = max(diff, float((a - b).abs().max()))
        if bool(((a - b).abs() > BF16_TOL + BF16_TOL * b.abs()).any()):
            bad.append(i)
    loss_diff = abs(float(rm["loss"]) - losses[-1])
    log(f"  remat step: loss {float(rm['loss']):.6f} vs {losses[-1]:.6f} "
        f"(diff {loss_diff:.3e}), largest parameter difference {diff:.3e} "
        f"({'bit-equal' if equal and loss_diff == 0 else 'not bit-equal'}),"
        f" peak memory {remat_peak:.2f} GiB above its input state (plain "
        f"step {step_peak:.2f})")
    if bad or loss_diff > BF16_TOL * (1 + abs(losses[-1])):
        raise AssertionError(f"remat step differs: loss {loss_diff}, "
                             f"leaves {bad[:8]}")
    del rp, rm, prev, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "times": times,
            "tok_s": tok_s, "peak_gib": peak, "step_peak_gib": step_peak,
            "remat_peak_gib": remat_peak, "losses": losses, "aux": auxes,
            "remat_diff": diff, "remat_bit_equal": equal and loss_diff == 0,
            "breakdown": prof}


def phase_lm_train():
    """Phase 13: full-width qwen3-1.7b training in bf16 (random weights from
    SERVE_SEED): ``train_steps`` on B=8 rows of T=512 from token_lm. The
    launch counters of a step must read exactly 57 rmsnorm_residual
    (forward and backward), 28 of each of swiglu, swiglu_backward,
    flash_attention_rope and flash_attention_backward, and nothing else;
    no plain-torch RoPE rotation (``ref.rope_rotate_hm``) may run in any
    step (the RoPE backward is one kernel launch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_sequences, token_lm
    from repro_torch.kernels import ref
    cfg = get_config(SERVE_ARCH)
    L = cfg.n_layers
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=TRAIN_B * TRAIN_T), TRAIN_T)
    batch = {"tokens": torch.as_tensor(rows, device="cuda").long()}
    want = want_launches(rmsnorm_residual=2 * L + 1,
                         rmsnorm_residual_backward=2 * L + 1, swiglu=L,
                         swiglu_backward=L, flash_attention_rope=L,
                         flash_attention_backward=L)
    rotations = []
    plain_rotate = ref.rope_rotate_hm

    def counted_rotate(*args, **kwargs):
        rotations.append(1)
        return plain_rotate(*args, **kwargs)

    ref.rope_rotate_hm = counted_rotate
    try:
        out = train_steps(SERVE_ARCH, cfg, serve_params(), batch, want)
    finally:
        ref.rope_rotate_hm = plain_rotate
    log(f"  plain-torch RoPE rotations (ref.rope_rotate_hm) in the steps: "
        f"{len(rotations)}")
    if rotations:
        raise AssertionError(f"{len(rotations)} plain RoPE rotations ran")
    return out


def phase_train_cuda_vs_cpu():
    """Phase 14: reduced qwen3 in f32, one make_lm_train_step step on the
    card (kernels) and on the CPU (plain versions) from the same
    parameters: loss within LOSS_TOL, parameters within TOL."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import make_lm_train_step
    cfg = dataclasses.replace(get_config(SERVE_ARCH + "-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(3, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    g = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (4, 100), generator=g)
    lb = LargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
    regime = Regime(base_lr=0.05, total_steps=10, drop_every=10)
    outs = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        step = make_lm_train_step(cfg, lb, regime, use_kernels=dev == "cuda")
        p2, _, m = step(p, sgd.init(p), {"tokens": tokens.to(dev)}, 0)
        outs[dev] = (float(m["loss"]), [t.cpu() for t in tree.leaves(p2)])
    log(f"train cuda vs cpu: {cfg.name} f32, B=4 T=100, one step: loss "
        f"{outs['cuda'][0]:.7f} vs {outs['cpu'][0]:.7f}")
    check_close("train step loss", torch.tensor(outs["cuda"][0]),
                torch.tensor(outs["cpu"][0]), LOSS_TOL)
    err = max(max_err(a, b) for a, b in zip(outs["cuda"][1], outs["cpu"][1]))
    check_close("train step params",
                torch.cat([t.reshape(-1) for t in outs["cuda"][1]]),
                torch.cat([t.reshape(-1) for t in outs["cpu"][1]]), TOL)
    return err


def train_rows(kern, train):
    """One JSON row per training kernel, per train step: ms is the device
    time of its kernels in the profiled step (every launch, inputs where
    the step leaves them); plain and library ms are per-call times at the
    step's shapes (phase 12, repeated inputs) times the calls (the norm
    backward: L calls with a residual cotangent and L + 1 without); the
    bound from the total bytes and operations of those calls."""
    from repro_torch.configs import get_config
    L = get_config(SERVE_ARCH).n_layers
    rows = []
    for name, (src, replaces, _, fam_name, _) in TRAIN_KERNELS.items():
        k = kern[name]
        if name == "rmsnorm_residual_backward":
            parts = [(k["residual"], L), (k["no residual"], L + 1)]
        elif name == "swiglu_backward":
            parts = [(k[TRAIN_B * TRAIN_T], L)]
        else:
            parts = [(k[TRAIN_T], L)]
        tot = {f: sum(r[f] * c for r, c in parts) for f in ("ms", "plain_ms")}
        nbytes = sum(r["work"][0] * c for r, c in parts)
        flops = sum(r["work"][1] * c for r, c in parts)
        bms, by = bound(nbytes, flops, parts[0][0]["work"][2])
        lib = [r["library_ms"] for r, _ in parts]
        in_step = train["breakdown"]["families"][fam_name]
        log(f"  {name}: {in_step:.3f} ms in the profiled step, "
            f"{tot['ms']:.3f} ms from its alone per-call times")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": k["err"], "ms": in_step,
            "plain_ms": tot["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": (None if None in lib else
                           sum(r["library_ms"] * c for r, c in parts))})
    return rows


# ---------------------------------------------------------------------------
# the SSM slice: falcon-mamba-7b serving and training (B10, B11, and the
# norm kernels B3, B4 under their autograd Functions)
# ---------------------------------------------------------------------------

MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_TRAIN_LAYERS = 16      # full width, depth cut from 64 to fit one card
# An accurate expf is one exp2 on the SFU: 16 results a clock an SM at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs, the H100 SXM's 1,980 MHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
MAMBA_SHAPES = [(1, 8, 128, 8), (2, 16, 256, 16), (2, 32, 512, 16),
                (2, 13, 128, 8), (2, 16, 100, 16), (3, 300, 200, 5),
                (1, 2048, 96, 16)]
# the first kernels (one thread a channel, before the redesign of several
# states a thread) at the timed shapes, by scripts/mamba_times.py on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md): events ms, device ms and kernels
# a call
MAMBA_BASELINE = {
    (8, 256, 8192, 16): {"mamba_chunk": (0.2675, 0.2621, 1),
                         "mamba_chunk_backward": (2.0825, 2.0767, 3)},
    (1, 256, 8192, 16): {"mamba_chunk": (0.1240, 0.1182, 1),
                         "mamba_chunk_backward": (0.8978, 0.9016, 3)},
}
MAMBA_KERNELS = {
    # name: (TPU kernel it replaces, profiler family, kernels a call)
    "mamba_chunk": ("src/repro/kernels/mamba_scan.py:60", "mamba_chunk_fwd",
                    1),
    "mamba_chunk_backward": ("src/repro/kernels/mamba_scan.py:166",
                             "mamba_chunk_bwd", 2),
}


def mamba_full_shape():
    """(B, c, di, ds) of every B10/B11 call of phases 16 and 17: B=8 rows,
    a 256-step chunk, falcon-mamba-7b's d_inner and d_state."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import DEFAULT_CHUNK
    cfg = get_config(MAMBA_ARCH)
    return (SERVE_B, DEFAULT_CHUNK, cfg.ssm.d_inner(cfg.d_model),
            cfg.ssm.d_state)


def mamba_work(B, c, di, ds, esize=4, backward=False):
    """(bytes, exps) of one call: each input read once, each output written
    once (xc, dt, Bm, Cm in ``esize`` bytes; A, h0, y, h_last, dy, dh_last,
    dA, dh0 in f32); one exp a (t, channel, state), which the function
    needs (the backward kernel takes a second in its recompute)."""
    nbytes = esize * (2 * B * c * di + 2 * B * c * ds) + 4 * (di * ds
                                                              + B * di * ds)
    if backward:    # dy, dh_last; dxc, ddt, dB, dC, dA, dh0
        nbytes += 4 * (B * c * di + B * di * ds) \
            + esize * (2 * B * c * di + 2 * B * c * ds) \
            + 4 * (di * ds + B * di * ds)
    else:           # y, h_last
        nbytes += 4 * (B * c * di + B * di * ds)
    return nbytes, B * c * di * ds


def mamba_bound(nbytes, exps):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, exps / SFU_EXP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mamba_inputs(gen, B, c, di, ds, dtype):
    """(xc, dt, Bm, Cm, A, h0), and the cotangents dy, dh_last, drawn as
    tests/test_kernels.py draws them."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    xc = randn(B, c, di).to(dtype)
    dt = (0.1 * F.softplus(randn(B, c, di))).to(dtype)
    Bm, Cm = randn(B, c, ds).to(dtype), randn(B, c, ds).to(dtype)
    A = -randn(di, ds).abs()
    return [xc, dt, Bm, Cm, A, randn(B, di, ds)], randn(B, c, di), \
        randn(B, di, ds)


def worst_close(label, pairs, tol):
    """allclose(rtol=atol=tol) of every (name, got, want); one log line with
    the largest error; raises naming the first pair outside."""
    errs = {}
    for name, got, want in pairs:
        g, w = got.detach().double(), want.detach().double()
        errs[name] = float((g - w).abs().max())
        if bool(((g - w).abs() > tol + tol * w.abs()).any()):
            raise AssertionError(f"{label} {name}: outside rtol=atol={tol} "
                                 f"(max abs err {errs[name]:.3e})")
    log(f"  {label:<40} max_abs_err {max(errs.values()):.3e} "
        f"({', '.join(f'{k} {v:.1e}' for k, v in errs.items())}) tol {tol:g}")
    return max(errs.values())


def mamba_da_f64(ins, dy, dhl, kern_da, plain_da):
    """Each f32 dA against autograd through the recurrence in float64 (a
    measurement beside phase 15's check, not a gate)."""
    import torch
    x, dt, Bm, Cm, A, h = (t.double() for t in ins)
    A = A.requires_grad_(True)
    loss = 0.0
    with torch.enable_grad():
        for t in range(x.shape[1]):
            h = torch.exp(dt[:, t, :, None] * A) * h \
                + (dt[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
            loss = loss + (torch.einsum("bds,bs->bd", h, Cm[:, t])
                           * dy[:, t].double()).sum()
        loss = loss + (h * dhl.double()).sum()
        da, = torch.autograd.grad(loss, A)
    log(f"  dA at the full-width shape against float64: kernel max abs err "
        f"{float((kern_da.double() - da).abs().max()):.3e}, plain "
        f"{float((plain_da.double() - da).abs().max()):.3e}, largest "
        f"|dA| {float(da.abs().max()):.4g}")


def mamba_plan_line(p) -> str:
    return (f"grid {p.grid} x {p.threads} threads ({p.channels} channels, "
            f"{p.q} of {p.DS} states a thread), {p.nseg} x {p.steps} steps, "
            f"ring {p.stages}" + (f", checkpoints in {p.ckpt}" if p.backward
                                  else "") + f", {p.smem_bytes} B")


def mamba_call_times():
    """Events and profiler device ms a call of B10 and B11 and the kernels a
    call launches, at the full-width shape and its solo row, from
    ``scripts/mamba_times.py`` in a process of its own: one profiler window
    a wrapper, taken as it is (late in this run the profiler has dropped
    the long backward kernel's events from whole windows). {(shape,
    wrapper): row}."""
    r = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                            "mamba_times.py")],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"scripts/mamba_times.py exited {r.returncode}"
                             f"\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    rows = {}
    for line in r.stdout.splitlines():
        if line.startswith("{") and '"wrapper"' in line:
            d = json.loads(line)
            rows[(tuple(d["shape"]), d["wrapper"])] = d
    return rows


def mamba_call_kernels(name, row):
    """Fails unless a call of B10 launches exactly its one kernel and a call
    of B11 exactly its two kernels and the dA sum (one reduction), each
    once: a window that lost a kernel's events fails too."""
    per_call = {k["name"]: k["n"] for k in row["kernels"]}
    main = MAMBA_KERNELS[name][1]
    mamba = {n: k for n, k in per_call.items() if "mamba_" in n}
    other = {n: k for n, k in per_call.items() if "mamba_" not in n}
    if name == "mamba_chunk":
        ok = list(mamba.values()) == [1] and not other
    else:
        ok = sorted(mamba.values()) == [1, 1] and list(other.values()) == [1]
        ok = ok and all("reduce" in n for n in other) and any(
            "mamba_dbc_reduce_kernel" in n for n in mamba)
    ok = ok and any(main in n for n in mamba) and row["device_ms"]
    if not ok:
        raise AssertionError(f"{name}: a call launches {per_call} (device "
                             f"{row['device_ms']} ms)")
    return sum(per_call.values())


def phase_mamba_kernels():
    """Phase 15: B10 (mamba_chunk) and B11 (mamba_chunk_backward) against
    their plain versions on the card, at the reference tests' shapes, a
    ragged chunk (c=13), a d_inner of 100 and of 200 with d_state 5, a
    2048-step chunk (the backward's checkpoints in its device scratch), the
    full-width (8, 256, 8192, 16) of phases 16 and 17 and its solo row: f32
    at TOL, bf16 inputs at BF16_TOL (the forward computes in f32 from the
    same values and is held to TOL), a non-zero h0 and live cotangents on
    both outputs. Two calls of each kernel are bit-equal; dt = 0 steps pass
    the state bit for bit (a left-padded row equals its unpadded run); two
    chained chunks equal one scan; the autograd Function's gradients equal
    plain autograd through the plain forward. At the full-width shape and
    its solo row: each wrapper's plan, CUDA-event and profiler device ms a
    call and the kernels a call (mamba_call_times; gated), beside
    MAMBA_BASELINE; the plain
    version's time and the bound at the full-width f32 shape. Returns
    {name: {"err", "ms", "device_ms", "plain_ms", "work"}}; err is the
    largest f32 error."""
    import torch
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(15)
    full = mamba_full_shape()
    solo = (1,) + tuple(full[1:])
    out = {k: {"err": 0.0} for k in MAMBA_KERNELS}
    names = ("dxc", "ddt", "dB", "dC", "dA", "dh0")
    log(f"mamba kernels vs plain: f32 at TOL, bf16 inputs at BF16_TOL; "
        f"built constants {MS.built_constants()}")
    # per call at the full-width f32 shape of the model path and its solo
    # row: CUDA events, profiler device time, kernels a call (from a process
    # of its own); the plain version and the bound at the full-width shape.
    # A run whose profiler window lost a kernel's events (as one did on the
    # card, early in a run) is measured again, three runs at most
    for attempt in range(3):
        times = mamba_call_times()
        try:
            for (_, name), t in times.items():
                mamba_call_kernels(name, t)
            break
        except AssertionError as e:
            if attempt == 2:
                raise
            log(f"  {e}: a window lost kernel events; measured again")
    for shape in (full, solo):
        for name in MAMBA_KERNELS:
            backward = name != "mamba_chunk"
            p = MS.plan(*shape, backward=backward)
            t = times[(shape, name)]
            events, device = t["events_ms"], t["device_ms"]
            n = mamba_call_kernels(name, t)
            base = MAMBA_BASELINE.get(shape, {}).get(name)
            work = mamba_work(*shape, backward=backward)
            bms, by = mamba_bound(*work)
            log(f"  timing {name} {shape} f32: events {events:.4f} ms, "
                f"device {device:.4f} ms a call, {n} kernels a call"
                + (f" (first kernels: events {base[0]:.4f}, device "
                   f"{base[1]:.4f}, {base[2]} kernels)" if base else "")
                + f"; bound {bms:.4f} ms by {by} ({work[0] / 1e6:.1f} MB, "
                f"{work[1] / 1e6:.1f} M exps); plan {mamba_plan_line(p)}")
            if shape == full:
                out[name].update(ms=events, device_ms=device, work=work)
    ins, dy, dhl = mamba_inputs(gen, *full, torch.float32)
    for name, plain, reps in (
            ("mamba_chunk", lambda: ref.mamba_chunk_ref(*ins), 3),
            ("mamba_chunk_backward",
             lambda: ref.mamba_chunk_backward_ref(*ins, dy, dhl), 2)):
        out[name]["plain_ms"] = time_ms(plain, reps)
        log(f"  timing {name} {full} f32 plain version: "
            f"{out[name]['plain_ms']:.3f} ms a call")
    del ins, dy, dhl
    torch.cuda.empty_cache()
    bodies = set()
    for shape in MAMBA_SHAPES + [full, solo]:
        pf, pb = (MS.plan(*shape, backward=b) for b in (False, True))
        bodies.add(pb.ckpt)
        log(f"  {shape} forward {mamba_plan_line(pf)}\n  {shape} backward "
            f"{mamba_plan_line(pb)}")
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            label = f"{shape} {'f32' if f32 else 'bf16'}"
            ins, dy, dhl = mamba_inputs(gen, *shape, dtype)
            fwd = MS.mamba_chunk(*ins)
            e_f = worst_close(f"mamba_chunk {label}", zip(
                ("y", "h_last"), fwd, ref.mamba_chunk_ref(*ins)), TOL)
            if not all(torch.equal(a, b) for a, b in zip(
                    MS.mamba_chunk(*ins), fwd)):
                raise AssertionError(f"forward {label}: two calls differ")
            got = MS.mamba_chunk_backward(*ins, dy, dhl)
            want = ref.mamba_chunk_backward_ref(*ins, dy, dhl)
            for g, w in zip(got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"backward {label}: {g.dtype} "
                                         f"{tuple(g.shape)} vs {w.dtype} "
                                         f"{tuple(w.shape)}")
            # dA sums B x c terms per (channel, state) in another order
            # than the plain version: held to tol relative to its largest
            # entry, as check_sum holds the GBN kernels' dgamma, dbeta
            e_b = max(worst_close(f"mamba_chunk_backward {label}", (
                (n, g.float(), w.float()) for n, g, w in zip(names, got, want)
                if n != "dA"), TOL if f32 else BF16_TOL),
                check_sum(f"mamba_chunk_backward {label} dA", got[4],
                          want[4], TOL if f32 else BF16_TOL))
            if shape == full and f32:
                mamba_da_f64(ins, dy, dhl, got[4], want[4])
            if f32:
                out["mamba_chunk"]["err"] = max(out["mamba_chunk"]["err"],
                                                e_f)
                out["mamba_chunk_backward"]["err"] = max(
                    out["mamba_chunk_backward"]["err"], e_b)
            again = MS.mamba_chunk_backward(*ins, dy, dhl)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"backward {label}: two calls differ")
            del ins, dy, dhl, got, want, again, fwd
    log("  two calls of each kernel bit-equal at every shape")
    if not {"smem", "scratch"} <= bodies:
        raise AssertionError(f"the backward's checkpoints lived only in "
                             f"{bodies}")

    # dt = 0 steps (left pads) pass the state bit for bit
    ins, _, _ = mamba_inputs(gen, *full, torch.float32)
    padded = [t.clone() for t in ins]
    padded[1][:, :100] = 0
    y, h = MS.mamba_chunk(*padded)
    ys, hs = MS.mamba_chunk(*(t[:, 100:].contiguous() for t in ins[:4]),
                            ins[4], ins[5])
    exact = torch.equal(h, hs) and torch.equal(y[:, 100:], ys)
    log(f"  100 dt=0 steps then 156 steps == the 156 steps alone: "
        f"{'bit for bit' if exact else 'DIFFERENT'}")
    if not exact:
        raise AssertionError("padded steps changed the state")
    del padded
    # two chained chunks equal one scan
    y, h = MS.mamba_chunk(*ins)
    y1, h1 = MS.mamba_chunk(*(t[:, :128].contiguous() for t in ins[:4]),
                            ins[4], ins[5])
    y2, h2 = MS.mamba_chunk(*(t[:, 128:].contiguous() for t in ins[:4]),
                            ins[4], h1)
    worst_close("two chained chunks == one", (
        ("y", torch.cat([y1, y2], 1), y), ("h_last", h2, h)), TOL)
    # the autograd Function against plain autograd through the plain forward
    small, _, _ = mamba_inputs(gen, 2, 40, 256, 16, torch.float32)
    cot = mamba_inputs(gen, 2, 40, 256, 16, torch.float32)[1:]
    grads = []
    for fn in (ops.mamba_chunk, ref.mamba_chunk_ref):
        leaves = [t.detach().requires_grad_(True) for t in small]
        yy, hh = fn(*leaves)
        grads.append(torch.autograd.grad(
            (yy * cot[0]).sum() + (hh * cot[1]).sum(), leaves))
    worst_close("autograd Function vs plain autograd", zip(
        names, *grads), TOL)

    return out


def all_launches():
    """Every launch counter of the decoder kernels, the SSM pair included."""
    from repro_torch.kernels import mamba_scan as MS
    return {**serving_launches(), **MS.launches}


def reset_all_launches():
    from repro_torch.kernels import mamba_scan as MS
    reset_serving_launches()
    MS.reset_launches()


def want_launches(**counts):
    """Every counter 0 but those given."""
    return {**{k: 0 for k in all_launches()}, **counts}


def phase_mamba_serve():
    """Phase 16: full-width falcon-mamba-7b generate in bf16 (random weights
    from SERVE_SEED): B=8 prompts left-padded to 512 (PROMPT_LENS), greedy,
    32 new tokens. The launch counters must show 2 mamba_chunk launches a
    layer (two 256-step chunks of the prefill, none in decode) and 65
    rmsnorm_residual launches a forward pass (64 layers and the final
    norm), nothing else; rows 0 and 7 must equal their unpadded runs.
    Prefill ms, decode ms a step, tokens/s, peak memory, and a profiled
    prefill and decode step by kernel family."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.ssm import DEFAULT_CHUNK
    from repro_torch.serving import generate, make_serve_step, prefill_fused
    cfg = get_config(MAMBA_ARCH)
    params = model_params(cfg)
    prompts = ragged_prompts(cfg.vocab_size, SERVE_SEED + 1)
    kw = dict(max_new_tokens=SERVE_NEW, prompt_lens=PROMPT_LENS)
    generate(params, cfg, prompts, **kw)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, n = cfg.n_layers, SERVE_NEW
    want = want_launches(mamba_chunk=L * -(-SERVE_P // DEFAULT_CHUNK),
                         rmsnorm_residual=(L + 1) * n)
    log(f"  generate: out {tuple(out.shape)} wall {wall * 1e3:.1f} ms "
        f"({SERVE_B * n / wall:.1f} new tokens/s end to end), peak memory "
        f"{peak:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"falcon-mamba launches {launches}, want {want}")
    if tuple(out.shape) != (SERVE_B, SERVE_P + n) or \
            not bool((out[:, SERVE_P:] < cfg.vocab_size).all()) or \
            not bool((out[:, SERVE_P:] >= 0).all()) or \
            not torch.equal(out[:, :SERVE_P], prompts):
        raise AssertionError("generate's output is malformed")
    for b in (0, SERVE_B - 1):
        Lb = PROMPT_LENS[b]
        prompt = prompts[b, SERVE_P - Lb:]
        solo = generate(params, cfg, prompt[None], max_new_tokens=n)
        solo, got = solo[0, Lb:].tolist(), out[b, SERVE_P:].tolist()
        log(f"  row {b} (prompt {Lb}) alone unpadded: "
            f"{'equal' if solo == got else 'DIFFERENT'}; batch {got[:8]}... "
            f"solo {solo[:8]}...")
        if solo != got:
            d, gap = solo_divergence(params, cfg, prompt.tolist(), solo, got)
            log(f"  first divergence of row {b} at generated token {d}; "
                f"top-2 logit gap of the solo run there {gap:.4g}")
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
    breakdown = {
        "decode step": family_profile("decode step", lambda: step(
            params, cache, tok, SERVE_P + n - 2, offsets=off)),
        "prefill": family_profile("prefill", lambda: prefill_fused(
            params, cfg, prompts, TT.init_cache(cfg, SERVE_B, SERVE_P + n),
            offsets=off))}
    fwd_calls = breakdown["prefill"]["calls"].get("mamba_chunk_fwd", 0)
    if fwd_calls != launches["mamba_chunk"]:
        raise AssertionError(f"profiled prefill ran {fwd_calls} B10 "
                             f"kernels, want {launches['mamba_chunk']}")
    del cache, params
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall * 1e3,
            "prefill_ms": prefill_ms, "decode_ms": dec, "peak_gib": peak,
            "breakdown": breakdown}


def mamba_invariance_probe():
    """Why the SSM mixer computes its two products over d_inner on at least
    INVARIANT_ROWS rows: for each, the values of the last M rows of a
    4096-row batch that differ when the M rows are computed alone, with a
    plain ``x @ w`` and through ``layers.rows_matmul``. A measurement printed
    beside phase 16, not a gate."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config(MAMBA_ARCH)
    di, dtr = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.resolved_dt_rank(
        cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(16)
    log("batch invariance of the d_inner products (bf16): values of M rows "
        "alone that differ from the same rows in a batch of 4096")
    for name, N in (("x_proj", dtr + 2 * cfg.ssm.d_state),
                    ("out_proj", cfg.d_model)):
        w = (torch.randn(di, N, generator=gen, device="cuda")
             / di ** 0.5).bfloat16()
        x = torch.randn(4096, di, generator=gen, device="cuda").bfloat16()
        for label, fn in (("x @ w", lambda a: a @ w),
                          ("rows_matmul", lambda a: layers.rows_matmul(a, w))):
            full = fn(x)
            counts = {M: int((fn(x[-M:]) != full[-M:]).sum())
                      for M in (512, 64, 8, 1)}
            log(f"  {name} ({di} x {N}) {label:<13} " + ", ".join(
                f"M={M}: {c} of {M * N}" for M, c in counts.items()))


def phase_mamba_train():
    """Phase 17: falcon-mamba-7b training at full width with the depth cut
    to MAMBA_TRAIN_LAYERS (bf16, random weights from SERVE_SEED):
    ``train_steps`` on B=8 rows of T=512 from token_lm. A step's launch
    counters must read exactly 2 mamba_chunk and 2 mamba_chunk_backward a
    layer, one rmsnorm_residual and one rmsnorm_residual_backward a layer
    and one more each for the final norm, nothing else; the profiled
    step's B10, B11 and norm-backward kernel counts must match them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_sequences, token_lm
    from repro_torch.models.ssm import DEFAULT_CHUNK
    cfg = dataclasses.replace(get_config(MAMBA_ARCH),
                              body_repeats=MAMBA_TRAIN_LAYERS)
    L = cfg.n_layers
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=TRAIN_B * TRAIN_T), TRAIN_T)
    batch = {"tokens": torch.as_tensor(rows, device="cuda").long()}
    chunks = L * -(-TRAIN_T // DEFAULT_CHUNK)
    want = want_launches(mamba_chunk=chunks, mamba_chunk_backward=chunks,
                         rmsnorm_residual=L + 1,
                         rmsnorm_residual_backward=L + 1)
    profiled = {name: (fam, per_call) for name, (_, fam, per_call)
                in MAMBA_KERNELS.items()}
    profiled["rmsnorm_residual_backward"] = tuple(
        TRAIN_KERNELS["rmsnorm_residual_backward"][3:])
    return train_steps(f"{cfg.name} ({L} layers)", cfg, model_params(cfg),
                       batch, want, profiled=profiled)


def phase_mamba_cuda_vs_cpu():
    """Phase 18: reduced falcon-mamba in f32, the same parameters on the
    card (kernels) and the CPU (plain versions): greedy tokens of ragged
    prompts equal and prefill logits within TOL; one make_lm_train_step
    step: loss within LOSS_TOL, parameters within TOL."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.serving import generate
    from repro_torch.train.trainer import make_lm_train_step
    cfg = dataclasses.replace(get_config(MAMBA_ARCH + "-reduced"),
                              dtype="float32")
    p_cpu = TT.init_params(3, cfg, device="cpu")
    p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
    P, lens = 300, (300, 131, 9, 1)
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (len(lens), P), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (4, 300), generator=g)
    lb = LargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
    regime = Regime(base_lr=0.05, total_steps=10, drop_every=10)
    outs, logits, steps = {}, {}, {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        outs[dev] = generate(p, cfg, prompts, max_new_tokens=8,
                             prompt_lens=lens, device=dev).cpu()
        cache = TT.init_cache(cfg, len(lens), P + 1, device=dev)
        off = torch.tensor([P - L for L in lens], device=dev,
                           dtype=torch.int32)
        lg, _ = TT.prefill_forward(p, cfg, prompts.to(dev), cache,
                                   offsets=off)
        logits[dev] = lg.cpu()
        step = make_lm_train_step(cfg, lb, regime, use_kernels=dev == "cuda")
        p2, _, m = step(p, sgd.init(p), {"tokens": tokens.to(dev)}, 0)
        steps[dev] = (float(m["loss"]), [t.cpu() for t in tree.leaves(p2)])
    log(f"mamba cuda vs cpu: {cfg.name} f32, B={len(lens)} P={P} ragged "
        f"{lens}, 8 new tokens; one train step B=4 T=300: loss "
        f"{steps['cuda'][0]:.7f} vs {steps['cpu'][0]:.7f}")
    check_close("prefill logits", logits["cuda"], logits["cpu"], TOL)
    same = torch.equal(outs["cuda"], outs["cpu"])
    log(f"  greedy tokens {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("greedy tokens differ between cuda and cpu")
    check_close("train step loss", torch.tensor(steps["cuda"][0]),
                torch.tensor(steps["cpu"][0]), LOSS_TOL)
    check_close("train step params",
                torch.cat([t.reshape(-1) for t in steps["cuda"][1]]),
                torch.cat([t.reshape(-1) for t in steps["cpu"][1]]), TOL)


def mamba_rows(kern, serve, train):
    """One JSON row per SSM kernel: B10 per falcon-mamba generate (its
    launches there), B11 per train step; ms, plain ms and the bound are
    the per-call numbers at the full-width f32 shape of every such call
    (phase 15) times the launches."""
    rows = []
    for name, (replaces, fam_name, _) in MAMBA_KERNELS.items():
        k = kern[name]
        n = (serve if name == "mamba_chunk" else train)["launches"][name]
        bms, by = mamba_bound(*k["work"])
        in_path = (serve["breakdown"]["prefill"] if name == "mamba_chunk"
                   else train["breakdown"])["families"].get(fam_name, 0.0)
        log(f"  {name}: {k['ms'] * n:.3f} ms from its per-call time x {n}; "
            f"{in_path:.3f} ms in the profiled "
            f"{'prefill' if name == 'mamba_chunk' else 'train step'}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": replaces, "launches": n, "max_abs_err": k["err"],
            "ms": k["ms"] * n, "plain_ms": k["plain_ms"] * n,
            "bound_ms": bms * n, "bound_by": by, "library_ms": None})
    return rows


# ---------------------------------------------------------------------------
# slice 6: the paper's sweeps (experiments runner, run-state checkpoints,
# obs hooks)
# ---------------------------------------------------------------------------

SWEEP_STEPS, SWEEP_EVERY = 48, 16
SWEEP_DATA = dict(seed=7, n_train=8192, n_test=1024, input_shape=(32, 32, 3),
                  n_classes=10, label_noise=0.05)
LM_SMOKE_STEPS, LM_SMOKE_EVERY = 8, 4
LM_SMOKE_ARCHS = ("qwen3-1.7b", "falcon-mamba-7b")


class Killed(Exception):
    """Raised by a ``log_fn`` to kill a run at a chosen evaluation."""


def launch_counts():
    """Every kernel's launch counter, the GBN pair's included."""
    from repro_torch.kernels import gbn as K
    return {**K.launches, **all_launches()}


def counting_obs():
    """An ``Observability`` whose spans also read the launch counters.
    Returns (obs, spans): each finished span appends its name, args, host
    ms and the launches by kernel made inside it."""
    import contextlib
    from repro_torch.obs import Observability
    obs = Observability()
    spans = []
    plain_span = obs.tracer.span

    @contextlib.contextmanager
    def span(name, **args):
        before, t0 = launch_counts(), time.perf_counter()
        with plain_span(name, **args):
            yield
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        spans.append({"name": name, **args, "ms": ms, "launches": {
            k: after[k] - before[k] for k in after if after[k] != before[k]}})

    obs.tracer.span = span
    return obs, spans


def traced_sweep(sweep, out_dir, label, **kw):
    """``run_sweep`` on the card under a ``counting_obs``; returns the
    records, per run in order its spans and all its launches, every span
    and the runner's messages."""
    from repro_torch.experiments.runner import run_sweep
    obs, spans = counting_obs()
    marks, msgs = [], []

    def log_fn(msg):
        log(f"  {label}: {msg}")
        msgs.append(msg)
        if ": running (" in msg:
            marks.append((len(spans), launch_counts()))

    records = run_sweep(sweep, out_dir, log_fn=log_fn, obs=obs,
                        device="cuda", **kw)
    marks.append((len(spans), launch_counts()))
    runs = []
    for (i, c0), (j, c1) in zip(marks, marks[1:]):
        runs.append({"spans": spans[i:j], "launches": {
            k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}})
    return records, runs, spans, msgs


def same_record(a, b) -> bool:
    """Equal in every field but ``wall_s`` (canonical JSON, so NaN fits
    compare equal)."""
    def canon(r):
        return json.dumps({k: v for k, v in r.items() if k != "wall_s"},
                          sort_keys=True)
    return canon(a) == canon(b)


def first_difference(a, b) -> str:
    for k in sorted(set(a) | set(b)):
        if k != "wall_s" and json.dumps(a.get(k), sort_keys=True) != \
                json.dumps(b.get(k), sort_keys=True):
            if k == "metrics":
                for name in sorted(set(a[k]) | set(b[k])):
                    if a[k].get(name) != b[k].get(name):
                        return f"metrics[{name!r}]: {a[k].get(name)} vs " \
                               f"{b[k].get(name)}"
            return f"{k}: {a.get(k)} vs {b.get(k)}"
    return "none"


def kill_and_resume(spec, ref, every: int, ckpt_dir):
    """Run ``spec`` with checkpoints every ``every`` steps, kill it at its
    step-``every`` evaluation (right after the first checkpoint), run it
    again from the checkpoint; the record must equal ``ref`` in every
    field but ``wall_s``. Returns the two parts' wall seconds."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.experiments.runner import run_one

    def killer(msg):
        if msg.startswith(f"step {every:5d}"):
            raise Killed(msg)

    t0 = time.perf_counter()
    try:
        run_one(spec, checkpoint_dir=ckpt_dir, checkpoint_every=every,
                log_fn=killer, device="cuda")
    except Killed:
        pass
    else:
        raise AssertionError(f"{spec.method}: the run was not killed")
    killed_s = time.perf_counter() - t0
    saved = latest_step(ckpt_dir)
    if saved != every:
        raise AssertionError(f"{spec.method}: latest checkpoint {saved}, "
                             f"want {every}")
    t0 = time.perf_counter()
    resumed = run_one(spec, checkpoint_dir=ckpt_dir, checkpoint_every=every,
                      device="cuda")
    resumed_s = time.perf_counter() - t0
    if not same_record(resumed, ref):
        raise AssertionError(f"{spec.method}: the resumed record differs "
                             f"from the uninterrupted one: "
                             f"{first_difference(resumed, ref)}")
    log(f"  kill at step {every} + resume from step {saved}: record equal "
        f"to the uninterrupted run's in every field but wall_s (killed part "
        f"{killed_s:.2f} s, resumed part {resumed_s:.2f} s, uninterrupted "
        f"wall_s {ref['wall_s']:.2f} s)")
    return killed_s, resumed_s


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_sweep(tmp):
    """Phase 19: the Table-1 sweep at full width through the runner.
    ``generalization_gap(steps=48, large_batch=4096, small_batch=128,
    ghost=128)`` on RESNET44_CIFAR10 (published widths, 44 layers) and
    SWEEP_DATA, ``use_kernels=True``, evaluating every 16 steps, through
    ``run_sweep(checkpoint_every=16)`` under a counting ``obs``: five
    records; each run's Table-1 row, wall_s, steps and median ms a step.
    Gates: B1 and B2 launch exactly 43 + 43 a step in the two +GBN columns
    and none in a step of the other three, none in an evaluation and none
    outside the steps; each record's steps is its regime's; every accuracy
    is finite. Then the LB+LR+GBN+RA run killed at its step-16 evaluation
    and resumed equals its record in every field but wall_s, and the
    sweep run again skips all five runs and runs no step. Last, a
    profiled train step of SB (B=128) and of LB (B=4096), the columns on
    the plain equal-weight BN."""
    from repro_torch.configs import RESNET44_CIFAR10
    from repro_torch.experiments import metrics as M
    from repro_torch.experiments.registry import generalization_gap
    from repro_torch.experiments.spec import DataSpec, replace_path
    sweep = generalization_gap(steps=SWEEP_STEPS, large_batch=BATCH,
                               small_batch=128, ghost=GHOST)
    base = sweep.base
    for path, value in (("model", RESNET44_CIFAR10),
                        ("data", DataSpec(**SWEEP_DATA)),
                        ("use_kernels", True), ("eval_every", SWEEP_EVERY)):
        base = replace_path(base, path, value)
    sweep = dataclasses.replace(sweep, base=base)
    specs = sweep.expand()
    out_dir = str(Path(tmp) / "sweeps")
    t0 = time.perf_counter()
    records, runs, _, _ = traced_sweep(sweep, out_dir, "sweep",
                                       checkpoint_every=SWEEP_EVERY)
    sweep_s = time.perf_counter() - t0
    if [r["run_id"] for r in records] != [s.run_id for s in specs] or \
            len(runs) != len(specs):
        raise AssertionError(f"sweep: {len(records)} records, {len(runs)} "
                             f"runs for {len(specs)} specs")
    log(f"generalization-gap on {RESNET44_CIFAR10.name} (full width), "
        f"{SWEEP_STEPS} steps, B={BATCH} vs 128, ghost {GHOST}, kernels on, "
        f"eval every {SWEEP_EVERY}, checkpoints every {SWEEP_EVERY}: "
        f"{sweep_s:.1f} s")
    log(M.format_table1(M.table1_view(records)))
    per_run = {}
    for spec, rec, run in zip(specs, records, runs):
        steps = [s for s in run["spans"] if s["name"] == "train.step"]
        evals = [s for s in run["spans"] if s["name"] == "train.eval"]
        want_steps = spec.regime().total_steps
        gbn = 43 if spec.lb.use_gbn else 0
        want = {"gbn_forward": gbn, "gbn_backward": gbn} if gbn else {}
        step_ms = median([s["ms"] for s in steps])
        log(f"  {spec.method:<13} b={spec.batch_size:<5d} steps "
            f"{rec['steps']:3d} wall_s {rec['wall_s']:7.2f} median "
            f"{step_ms:8.2f} ms a step (first {steps[0]['ms']:.2f}); "
            f"{len(evals)} evals, median {median([e['ms'] for e in evals]):.2f}"
            f" ms; launches {run['launches']}; final_acc "
            f"{rec['final_acc']:.4f} best {rec['best_acc']:.4f} train "
            f"{rec['train_acc']:.4f}")
        if rec["steps"] != want_steps or len(steps) != want_steps:
            raise AssertionError(f"{spec.method}: {rec['steps']} steps, "
                                 f"{len(steps)} step spans, want "
                                 f"{want_steps}")
        bad = [s for s in steps if s["launches"] != want]
        if bad:
            raise AssertionError(f"{spec.method}: step {bad[0]['step']} "
                                 f"launched {bad[0]['launches']}, want {want}")
        if any(e["launches"] for e in evals):
            raise AssertionError(f"{spec.method}: an evaluation launched "
                                 f"kernels: {[e['launches'] for e in evals]}")
        total = {k: v * want_steps for k, v in want.items()}
        if run["launches"] != total:
            raise AssertionError(f"{spec.method}: the run launched "
                                 f"{run['launches']}, want {total}")
        if not all(math.isfinite(rec[k])
                   for k in ("final_acc", "best_acc", "train_acc")):
            raise AssertionError(f"{spec.method}: accuracy not finite")
        per_run[spec.method] = {"wall_s": rec["wall_s"], "steps": rec["steps"],
                                "step_ms": step_ms}

    ra = specs[-1]
    if ra.method != "LB+LR+GBN+RA":
        raise AssertionError(f"last column is {ra.method}")
    killed_s, resumed_s = kill_and_resume(
        ra, records[-1], SWEEP_EVERY, str(Path(tmp) / "resume" / ra.run_id))

    t0 = time.perf_counter()
    again, reruns, spans, msgs = traced_sweep(
        sweep, out_dir, "again", checkpoint_every=SWEEP_EVERY)
    skip_s = time.perf_counter() - t0
    if spans or reruns or len(msgs) != len(specs) or \
            not all(m.endswith("skipping") for m in msgs):
        raise AssertionError(f"the second pass ran {len(reruns)} runs, "
                             f"{len(spans)} spans: {msgs}")
    if not all(same_record(a, b) for a, b in zip(again, records)) or \
            len(again) != len(records):
        raise AssertionError("the second pass returned other records")
    log(f"  second pass: all {len(specs)} runs skipped, no step run, "
        f"{skip_s:.2f} s")

    # where a step's time goes in the columns without B1/B2: SB at B=128
    # and LB at B=4096, both on the plain equal-weight BN
    data = base.data.build()
    for spec in specs[:2]:
        per_run[spec.method]["profiled_ms"] = phase_step_time(
            f"sweep {spec.method} b={spec.batch_size}", spec.model, data,
            spec.lb, spec.regime())
    return {"sweep_s": sweep_s, "runs": per_run, "killed_s": killed_s,
            "resumed_s": resumed_s, "skip_s": skip_s}


def lm_smoke_launches(cfg, chunk_len):
    """A reduced LM train step's launches by kernel (forward and backward):
    qwen3 as phase 13's gate at the reduced depth, falcon-mamba as phase
    17's."""
    from repro_torch.models.ssm import DEFAULT_CHUNK
    L = cfg.n_layers
    if cfg.ssm is not None:
        chunks = L * -(-chunk_len // DEFAULT_CHUNK)
        return want_launches(mamba_chunk=chunks, mamba_chunk_backward=chunks,
                             rmsnorm_residual=L + 1,
                             rmsnorm_residual_backward=L + 1)
    return want_launches(rmsnorm_residual=2 * L + 1,
                         rmsnorm_residual_backward=2 * L + 1,
                         swiglu=L, swiglu_backward=L,
                         flash_attention_rope=L, flash_attention_backward=L)


def phase_lm_sweeps(tmp):
    """Phase 20: ``lm_smoke(steps=8)`` through the runner for reduced
    qwen3-1.7b and falcon-mamba-7b in f32, ``use_kernels=True`` as
    registered, two methods each, checkpoints every 4 steps, under a
    counting ``obs``. Gates: every step launches exactly the train step's
    kernels (``want_launches``); an evaluation exactly the forward ones
    once per holdout chunk, as does the final evaluation; steps as the
    regime says, CE finite. Then the qwen3 LB+LR+NOISE run (gradient
    noise) killed at its step-4 evaluation and resumed equals its record
    in every field but wall_s."""
    from repro_torch.experiments.registry import lm_smoke
    from repro_torch.experiments.runner import _lm_config
    out = {}
    for arch in LM_SMOKE_ARCHS:
        sweep = lm_smoke(steps=LM_SMOKE_STEPS, arch=arch)
        specs = sweep.expand()
        t0 = time.perf_counter()
        records, runs, _, _ = traced_sweep(
            sweep, str(Path(tmp) / "lm"), arch,
            checkpoint_every=LM_SMOKE_EVERY)
        wall = time.perf_counter() - t0
        for spec, rec, run in zip(specs, records, runs):
            cfg = _lm_config(spec)
            step_want = {k: v for k, v in
                         lm_smoke_launches(cfg, spec.lm_seq_len).items() if v}
            fwd = {k: v for k, v in step_want.items()
                   if not k.endswith("_backward")}
            n_rows = spec.lm_n_tokens // spec.lm_seq_len
            holdout = max(spec.lb.batch_size, n_rows // 10)
            chunks = -(-holdout // spec.lb.batch_size)
            eval_want = {k: v * chunks for k, v in fwd.items()}
            steps = [s for s in run["spans"] if s["name"] == "train.step"]
            evals = [s for s in run["spans"] if s["name"] == "train.eval"]
            n_steps = spec.regime().total_steps
            log(f"  {arch} {spec.method:<12} b={spec.batch_size:<3d} steps "
                f"{rec['steps']} final_ce {rec['final_ce']:.4f} wall_s "
                f"{rec['wall_s']:.2f} median {median([s['ms'] for s in steps]):.2f}"
                f" ms a step; a step launches {steps[-1]['launches']}; an "
                f"eval ({chunks} chunks) {evals[-1]['launches']}")
            if rec["steps"] != n_steps or len(steps) != n_steps:
                raise AssertionError(f"{arch} {spec.method}: {rec['steps']} "
                                     f"steps, want {n_steps}")
            bad = [s for s in steps if s["launches"] != step_want]
            if bad:
                raise AssertionError(f"{arch} {spec.method}: step "
                                     f"{bad[0]['step']} launched "
                                     f"{bad[0]['launches']}, want {step_want}")
            bad = [e for e in evals if e["launches"] != eval_want]
            if bad or not evals:
                raise AssertionError(f"{arch} {spec.method}: evaluations "
                                     f"launched {[e['launches'] for e in evals]}"
                                     f", want {eval_want} each")
            total = {k: n_steps * step_want.get(k, 0)
                     + (len(evals) + 1) * eval_want.get(k, 0)
                     for k in step_want}
            if run["launches"] != total:
                raise AssertionError(f"{arch} {spec.method}: the run "
                                     f"launched {run['launches']}, want "
                                     f"{total}")
            if not math.isfinite(rec["final_ce"]):
                raise AssertionError(f"{arch} {spec.method}: CE not finite")
        out[arch] = wall
        if arch == LM_SMOKE_ARCHS[0]:
            kill_and_resume(specs[-1], records[-1], LM_SMOKE_EVERY,
                            str(Path(tmp) / "lm-resume" / specs[-1].run_id))
    return out


# ---------------------------------------------------------------------------
# slice 7: the MoE family (qwen2-moe-a2.7b at full width; qwen2-moe and
# kimi-k2 reduced card against CPU)
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_TRAIN_LAYERS = 2         # full width, depth cut from 24 to fit one card
MOE_ENGINE_REQUESTS = 8      # the first requests of ENGINE_TRACE
MOE_REDUCED = ("qwen2-moe-a2.7b-reduced", "kimi-k2-1t-a32b-reduced")
NEAR_TIE = 1e-6              # a k-th/(k+1)-th probability margin below it
# The op that launched a kernel names its family on the MoE path (the
# profiler links each kernel to the innermost op on the stack at its
# launch): the routed experts' batched products, the rows written by index
# (the dispatch, and the combine's backward) and read by index (the
# combine, and the dispatch's backward), and the routing's sorts.
MOE_OPS = {"aten::bmm": "moe_bmm",
           "aten::index_copy_": "moe_scatter", "aten::index_add_":
           "moe_scatter", "aten::index_fill_": "moe_scatter",
           "aten::index_select": "moe_gather",
           "aten::_softmax": "moe_route", "aten::topk": "moe_route",
           "aten::sort": "moe_route", "aten::cummax": "moe_route"}
# ... and only inside the MoE layer: its forward (the "moe_apply" span that
# moe_spans opens around each call) and, in the backward, the autograd
# nodes of its batched products and indexed reads and writes. The same ops
# elsewhere (F.embedding's index_select) keep their kernel's own family.
MOE_SCOPES = ("moe_apply", "BmmBackward0", "IndexSelectBackward0",
              "IndexCopyBackward0")
MOE_LABELS = (MOE_OPS, MOE_SCOPES)


@contextlib.contextmanager
def profiler_spans(targets):
    """While the block runs, every call of each (module, function name,
    span) target runs inside a profiler span of that name (a
    record_function, a few microseconds a call)."""
    import torch

    def spanned(fn, span):
        def call(*args, **kwargs):
            with torch.profiler.record_function(span):
                return fn(*args, **kwargs)
        return call

    saved = [getattr(mod, name) for mod, name, _ in targets]
    for (mod, name, span), fn in zip(targets, saved):
        setattr(mod, name, spanned(fn, span))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(targets, saved):
            setattr(mod, name, fn)


def moe_spans():
    """Every ``moe_apply`` call inside a profiler span named "moe_apply"."""
    from repro_torch.models import moe as MOE
    return profiler_spans([(MOE, "moe_apply", "moe_apply")])


@contextlib.contextmanager
def drops_counted(counts, prefill_len):
    """Within: each ``moe._slots`` call adds its dropped and routed
    assignments (device tensors, no sync) to ``counts["prefill"]`` (calls
    over ``prefill_len`` tokens) or ``counts["decode"]``."""
    from repro_torch.models import moe as MOE
    real = MOE._slots

    def slots(topi, C):
        slot, keep = real(topi, C)
        kind = "prefill" if topi.shape[1] == prefill_len else "decode"
        counts.setdefault(kind, []).append(((~keep).sum(), keep.numel()))
        return slot, keep

    MOE._slots = slots
    try:
        yield counts
    finally:
        MOE._slots = real


def drop_shares(counts):
    return {k: sum(int(d) for d, _ in v) / sum(n for _, n in v)
            for k, v in counts.items()}


def phase_moe_serve():
    """Phase 21: full-width qwen2-moe-a2.7b generate in bf16 (random weights
    from SERVE_SEED): the prompts of phase 7, greedy, 32 new tokens. The
    launch counters must show exactly 24 flash_attention, 744 flash_decode,
    1568 rmsnorm_residual (49 a pass: each layer's pre-attention norm and
    its fused residual pre-MoE norm, and the final norm) and 768 swiglu
    (the shared expert, a layer a pass), nothing else; a second run gives
    the same tokens bit for bit. Drop shares at prefill and decode,
    prefill ms, decode ms a step, tokens/s, peak memory, a profiled
    prefill and decode step by family (the routed experts' products, the
    dispatch and combine and the routing named apart by the op that
    launched them), and a profiled generate: each kernel's device ms and
    kernels. Returns the measurements and the parameters (phase 22 serves
    them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate, make_serve_step, prefill_fused
    cfg = get_config(MOE_ARCH)
    params = model_params(cfg)
    prompts = ragged_prompts(cfg.vocab_size, SERVE_SEED + 1)
    kw = dict(max_new_tokens=SERVE_NEW, prompt_lens=PROMPT_LENS)
    generate(params, cfg, prompts, **kw)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, n = cfg.n_layers, SERVE_NEW
    want = want_launches(flash_attention=L, flash_decode=L * (n - 1),
                         rmsnorm_residual=(2 * L + 1) * n, swiglu=L * n)
    log(f"  generate: out {tuple(out.shape)} wall {wall * 1e3:.1f} ms "
        f"({SERVE_B * n / wall:.1f} new tokens/s end to end), peak memory "
        f"{peak:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"{MOE_ARCH} launches {launches}, want {want}")
    if tuple(out.shape) != (SERVE_B, SERVE_P + n) or \
            not bool((out[:, SERVE_P:] < cfg.vocab_size).all()) or \
            not bool((out[:, SERVE_P:] >= 0).all()) or \
            not torch.equal(out[:, :SERVE_P], prompts):
        raise AssertionError("generate's output is malformed")

    # a second run, its assignments counted: the same tokens bit for bit
    with drops_counted({}, SERVE_P) as counts:
        again = generate(params, cfg, prompts, **kw)
    same = torch.equal(again, out)
    shares = drop_shares(counts)
    C_pre, C_dec = (cfg.moe.tokens_capacity(SERVE_P),
                    cfg.moe.tokens_capacity(SERVE_B))
    log(f"  a second generate: tokens {'bit-equal' if same else 'DIFFERENT'}"
        f"; dropped assignments: prefill {shares['prefill']:.4f} (C = "
        f"{C_pre} a sequence of {SERVE_P}, mean load "
        f"{SERVE_P * cfg.moe.top_k / cfg.moe.n_experts:.1f}), decode "
        f"{shares['decode']:.4f} (C = {C_dec}: the {SERVE_B} rows pool)")
    if not same:
        raise AssertionError("two generate runs gave different tokens")

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
    with moe_spans():
        breakdown = {
            "decode step": family_profile("decode step", lambda: step(
                params, cache, tok, SERVE_P + n - 2, offsets=off),
                by_op=MOE_LABELS),
            "prefill": family_profile("prefill", lambda: prefill_fused(
                params, cfg, prompts,
                TT.init_cache(cfg, SERVE_B, SERVE_P + n), offsets=off),
                by_op=MOE_LABELS)}
        del cache
        # one whole generate under the profiler: each kernel's device ms
        busy, kernels = profile_device_ms(
            lambda: generate(params, cfg, prompts, **kw), reps=1, warm=False,
            by_op=MOE_LABELS)
    fam, calls = by_family(kernels)
    log(f"  profiled generate: device busy {busy or 0.0:.2f} ms of "
        f"{wall * 1e3:.1f}; device ms by family "
        f"{ {k: round(v, 3) for k, v in sorted(fam.items())} } (kernels "
        f"{dict(sorted(calls.items()))})")
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall * 1e3,
            "prefill_ms": prefill_ms, "decode_ms": dec, "peak_gib": peak,
            "drop_shares": shares, "breakdown": breakdown,
            "families": fam, "calls": calls}, params


def phase_moe_engine(params):
    """Phase 22: ContinuousEngine on full-width qwen2-moe-a2.7b in bf16 (the
    parameters of phase 21): phase 10's slots, max_len and pages of 16, a
    paged bf16 pool, greedy, the first MOE_ENGINE_REQUESTS requests of
    ENGINE_TRACE. Every request must complete; the launch counters must
    show exactly 24 flash_decode_paged launches a step, 24 flash_attention
    launches an admission, 49 rmsnorm_residual and 24 swiglu launches a
    pass, and no flash_decode launch. Every slot decodes every step, idle
    ones too, and takes decode capacity as in the reference. Useful
    tokens/s, then the run again under the profiler: the paged kernel's
    device ms over the run, its count checked against the counter."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import ContinuousEngine, poisson_trace
    cfg = get_config(MOE_ARCH)
    L = cfg.n_layers
    trace = poisson_trace(cfg, **ENGINE_TRACE)[:MOE_ENGINE_REQUESTS]
    kw = dict(num_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
              layout="paged", page_size=ENGINE_PAGE)
    log(f"engine {MOE_ARCH} bf16: {kw}, default pool; the first "
        f"{len(trace)} requests of {ENGINE_TRACE}: prompts "
        f"{[len(r.prompt) for r in trace]}, "
        f"{sum(r.max_new_tokens for r in trace)} tokens asked for")
    eng = ContinuousEngine(params, cfg, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    comps = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, admits = int(st["steps"]), len(trace)
    want = want_launches(flash_decode_paged=L * steps,
                         flash_attention=L * admits,
                         rmsnorm_residual=(2 * L + 1) * (steps + admits),
                         swiglu=L * (steps + admits))
    log(f"  {ENGINE_SLOTS} slots: { {k: round(v, 3) for k, v in st.items()} }"
        f"; wall {wall:.2f} s; peak memory {peak:.2f} GiB; launches "
        f"{launches}")
    toks = {i: c.tokens for i, c in comps.items()}
    bad = [r.id for r in trace if len(toks.get(r.id, ())) != r.max_new_tokens
           or not all(0 <= t < cfg.vocab_size for t in toks[r.id])]
    if sorted(toks) != [r.id for r in trace] or bad:
        raise AssertionError(f"requests incomplete or out of vocabulary: "
                             f"{bad}")
    if launches != want:
        raise AssertionError(f"engine launches {launches}, want {want}")
    del eng
    torch.cuda.empty_cache()
    for attempt in range(2):
        eng = ContinuousEngine(params, cfg, **kw)
        reset_all_launches()
        busy, kernels = profile_device_ms(lambda: eng.run(trace), reps=1,
                                          warm=False, host=False, tries=1)
        fam, calls = by_family(kernels)
        paged = all_launches()["flash_decode_paged"]
        if calls.get("flash_decode_paged") == paged:
            break
        msg = (f"the profile holds {calls.get('flash_decode_paged')} paged "
               f"decode kernels, the counter {paged}")
        if attempt == 1:
            raise AssertionError(msg)
        log(f"  {msg}; profiling the run again")
        del eng
    log(f"  profiled run: device busy {busy or 0.0:.1f} ms (idle share "
        f"{1 - (busy or 0.0) / 1e3 / st['elapsed_s']:.3f} of the unprofiled "
        f"run's {st['elapsed_s']:.2f} s); device ms by family "
        f"{ {k: round(v, 3) for k, v in sorted(fam.items())} }")
    del eng
    # one profiled decode step with every request admitted at once
    eng = ContinuousEngine(params, cfg, **kw)
    step, prof = eng.step, {}

    def profiled_step():
        if eng.steps == 8:
            with moe_spans():
                prof.update(family_profile(
                    f"engine decode step ({int(eng.active.sum())} active "
                    f"rows of {ENGINE_SLOTS})", step, by_op=MOE_LABELS))
            raise _Stop
        step()

    eng.step = profiled_step
    try:
        eng.run([dataclasses.replace(r, arrival=0.0) for r in trace])
    except _Stop:
        pass
    del eng
    gc.collect()        # the patched step holds a cycle with eng
    torch.cuda.empty_cache()
    return {"stats": st, "wall_s": wall, "peak_gib": peak,
            "launches": launches, "families": fam, "calls": calls,
            "step_profile": prof}


def phase_moe_train():
    """Phase 23: qwen2-moe-a2.7b training at full width with the depth cut
    to MOE_TRAIN_LAYERS (bf16, random weights from SERVE_SEED):
    ``train_steps`` on B=8 rows of T=512 from token_lm, moe_aux collected:
    a step's launch counters must read exactly 5/5 rmsnorm_residual and its
    backward (two a layer and the final norm), 2/2 swiglu and its backward
    (the shared expert), 2/2 flash_attention_rope and
    flash_attention_backward, nothing else; the profiled step names the
    MoE layer's kernels by family (MOE_LABELS)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_sequences, token_lm
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, body_repeats=MOE_TRAIN_LAYERS)
    L = cfg.n_layers
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=TRAIN_B * TRAIN_T), TRAIN_T)
    batch = {"tokens": torch.as_tensor(rows, device="cuda").long()}
    want = want_launches(rmsnorm_residual=2 * L + 1,
                         rmsnorm_residual_backward=2 * L + 1, swiglu=L,
                         swiglu_backward=L, flash_attention_rope=L,
                         flash_attention_backward=L)
    return train_steps(f"{cfg.name} ({L} of {full.n_layers} layers, full "
                       f"width)", cfg, model_params(cfg), batch, want,
                       by_op=MOE_LABELS, spans=moe_spans, aux_key="moe_aux")


@contextlib.contextmanager
def routing_recorded(log_):
    """Within: each MoE layer appends its routing input, router weights,
    topi, slot, keep and C (on the host) to ``log_``."""
    from repro_torch.models import moe as MOE
    real = (MOE._route, MOE._slots)

    def route(router_w, x, m, losses=True):
        out = real[0](router_w, x, m, losses)
        log_.append({"x": x.float().cpu(), "router": router_w.float().cpu(),
                     "topi": out[0].cpu()})
        return out

    def slots(topi, C):
        slot, keep = real[1](topi, C)
        log_[-1].update(slot=slot.cpu(), keep=keep.cpu(), C=C)
        return slot, keep

    MOE._route, MOE._slots = route, slots
    try:
        yield log_
    finally:
        MOE._route, MOE._slots = real


def same_routing(label, a, b):
    """Layer by layer: topi equal but for near-ties (two of a token's k + 1
    largest probabilities within NEAR_TIE, from ``a``'s inputs in f64;
    counted and printed), then C, and slot and keep on every sequence
    routed alike. Raises on any other difference."""
    import torch
    if len(a) != len(b) or not a:
        raise AssertionError(f"{label}: {len(a)} and {len(b)} MoE layers")
    flips = 0
    for i, (x, y) in enumerate(zip(a, b)):
        diff = (x["topi"] != y["topi"]).any(-1)
        if diff.any():
            k = x["topi"].shape[-1]
            p = torch.softmax(x["x"].double() @ x["router"].double(), -1)
            top = p.sort(-1, descending=True).values[..., :k + 1]
            tie = ((top[..., :-1] - top[..., 1:]) < NEAR_TIE).any(-1)
            if (diff & ~tie).any():
                raise AssertionError(
                    f"{label} layer {i}: {int((diff & ~tie).sum())} tokens "
                    f"routed differently with no near-tie")
            flips += int(diff.sum())
        alike = ~diff.any(-1)
        if x["C"] != y["C"] or \
                not torch.equal(x["slot"][alike], y["slot"][alike]) or \
                not torch.equal(x["keep"][alike], y["keep"][alike]):
            raise AssertionError(f"{label} layer {i}: slots or keep differ")
    drops = sum(int((~x["keep"]).sum()) for x in a)
    total = sum(x["keep"].numel() for x in a)
    log(f"  {label}: routing equal over {len(a)} MoE layers ({flips} "
        f"near-tie tokens routed differently); {drops} of {total} "
        f"assignments dropped")
    return flips


def phase_moe_cuda_vs_cpu():
    """Phase 24: reduced qwen2-moe-a2.7b and kimi-k2-1t-a32b in f32, the
    same parameters on the card (kernels) and the CPU (the plain model
    path, ``use_kernels=False``: the model's own softmax attention, not
    the kernels' plain versions), at the configs' capacity factor: the
    ragged prefill's routing equal layer by layer, left pads included (the
    near-tie rule), prefill logits within TOL, greedy tokens of ragged
    prompts equal; one make_lm_train_step step: loss within LOSS_TOL,
    parameters within TOL."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.serving import generate
    from repro_torch.train.trainer import make_lm_train_step
    for name, hd in [(m, None) for m in MOE_REDUCED] + [
            ("kimi-k2-1t-a32b-reduced", 112)]:
        cfg = dataclasses.replace(get_config(name), dtype="float32",
                                  **({} if hd is None else {"head_dim": hd}))
        p_cpu = TT.init_params(3, cfg, device="cpu")
        p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
        P, lens = 40, (40, 23, 9, 1)
        g = torch.Generator().manual_seed(4)
        prompts = torch.randint(0, cfg.vocab_size, (len(lens), P),
                                generator=g)
        tokens = torch.randint(0, cfg.vocab_size, (4, 100), generator=g)
        lb = LargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
        regime = Regime(base_lr=0.05, total_steps=10, drop_every=10)
        outs, logits, steps, routes = {}, {}, {}, {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            kern = dev == "cuda"
            outs[dev] = generate(p, cfg, prompts, max_new_tokens=8,
                                 prompt_lens=lens, use_kernels=kern,
                                 device=dev).cpu()
            cache = TT.init_cache(cfg, len(lens), P + 1, device=dev,
                                  layout="head" if kern else "seq")
            off = torch.tensor([P - L for L in lens], device=dev,
                               dtype=torch.int32)
            with routing_recorded([]) as routes[dev]:
                lg, _ = TT.prefill_forward(p, cfg, prompts.to(dev), cache,
                                           use_kernels=kern, offsets=off)
            logits[dev] = lg.cpu()
            step = make_lm_train_step(cfg, lb, regime, use_kernels=kern)
            p2, _, m = step(p, sgd.init(p), {"tokens": tokens.to(dev)}, 0)
            steps[dev] = (float(m["loss"]), float(m["moe_aux"]),
                          [t.cpu() for t in tree.leaves(p2)])
        log(f"moe cuda vs cpu: {cfg.name} hd {cfg.head_dim} f32, "
            f"B={len(lens)} P={P} ragged "
            f"{lens}, 8 new tokens; one train step B=4 T=100: loss "
            f"{steps['cuda'][0]:.7f} vs {steps['cpu'][0]:.7f}, moe_aux "
            f"{steps['cuda'][1]:.7f} vs {steps['cpu'][1]:.7f}")
        same_routing(f"{cfg.name} prefill routing", routes["cuda"],
                     routes["cpu"])
        check_close("prefill logits", logits["cuda"], logits["cpu"], TOL)
        same = torch.equal(outs["cuda"], outs["cpu"])
        log(f"  greedy tokens {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{cfg.name}: greedy tokens differ between "
                                 f"cuda and cpu")
        check_close("train step loss", torch.tensor(steps["cuda"][0]),
                    torch.tensor(steps["cpu"][0]), LOSS_TOL)
        check_close("train step params",
                    torch.cat([t.reshape(-1) for t in steps["cuda"][2]]),
                    torch.cat([t.reshape(-1) for t in steps["cpu"][2]]), TOL)


def moe_kernel_line(serve, engine, train):
    """The MoE path's kernels: device ms and launches in the profiled
    generate (B3, B5, B9, B12), the profiled engine run (B13) and the
    profiled 2-layer train step (B4, B6, B7, B8)."""
    fams = {"rmsnorm_residual": ("rmsnorm_residual", serve),
            "swiglu": ("swiglu", serve), "flash_attention":
            ("flash_fwd", serve), "flash_decode": ("flash_decode", serve),
            "flash_decode_paged": ("flash_decode_paged", engine)}
    rows = {name: (src["families"].get(fam, 0.0), src["launches"][name])
            for name, (fam, src) in fams.items()}
    for name, (*_, fam, _) in TRAIN_KERNELS.items():
        rows[name] = (train["breakdown"]["families"].get(fam, 0.0),
                      train["launches"][name])
    return rows


def moe_summary(ms_, me_, mt_):
    """The slice's end-to-end numbers and its kernels' line."""
    from repro_torch.configs import get_config
    log(f"serve {MOE_ARCH} (B={SERVE_B}, P={SERVE_P} ragged, {SERVE_NEW} new "
        f"tokens): generate {ms_['wall_ms']:.1f} ms, prefill "
        f"{ms_['prefill_ms']:.2f} ms, decode {ms_['decode_ms']:.3f} ms a "
        f"step, {SERVE_B * SERVE_NEW / ms_['wall_ms'] * 1e3:.1f} new "
        f"tokens/s, peak {ms_['peak_gib']:.2f} GiB, dropped assignments "
        f"{ {k: round(v, 4) for k, v in ms_['drop_shares'].items()} }; "
        f"engine ({MOE_ENGINE_REQUESTS} requests, {me_['stats']['steps']:.0f}"
        f" steps) {me_['stats']['useful_tok_s']:.1f} useful tokens/s, "
        f"{me_['launches']['flash_decode_paged']} flash_decode_paged "
        f"launches; train {MOE_TRAIN_LAYERS} of "
        f"{get_config(MOE_ARCH).n_layers} layers "
        f"(bf16, "
        f"B={TRAIN_B}, T={TRAIN_T}): median step {mt_['step_ms']:.1f} ms, "
        f"{mt_['tok_s']:.0f} tokens/s, peak {mt_['peak_gib']:.2f} GiB, "
        f"moe_aux {mt_['aux'][-1]:.4f}")
    log(f"moe path kernels (device ms and launches: generate, engine run, "
        f"train step): " + ", ".join(
            f"{name} {ms:.3f} ms {n} launches" for name, (ms, n) in
            moe_kernel_line(ms_, me_, mt_).items()))


# ---------------------------------------------------------------------------
# slice 8: the encoder-decoder and vision-LM families, and jamba's hybrid
# stack (Mamba + attention + MoE)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "llama-3.2-vision-11b"
JAMBA_ARCH = "jamba-v0.1-52b"
ENCDEC_P = 128                     # seamless's prompts, left-padded ...
ENCDEC_LENS = (128, 112, 96, 80, 64, 48, 32, 16)     # ... to these lengths
ENCDEC_FRAMES = 512                # the served memory: encoded stub frames
VLM_TRAIN_LAYERS = 10              # full width, 2 of llama-vision's 8 periods
JAMBA_LAYERS = 16                  # full width, 2 of jamba's 4 periods
NEW_REDUCED = tuple(f"{a}-reduced" for a in (
    ENCDEC_ARCH, VLM_ARCH, JAMBA_ARCH, "phi3-medium-14b", "gemma3-27b",
    "h2o-danube-3-4b"))
# B9's key tile and B12's chunk (64 slots, or 32 at hd 128 in bf16): a
# left pad that is a multiple of it keeps a row's keys where its unpadded
# run has them, so the row's sums meet the same operands in the same order
KEY_TILE = 64
# the profiler spans around the encoder and each cross-attention sublayer;
# a cuBLAS or other kernel launched inside one is counted as its family
MEMORY_SCOPES = ("encode", "cross_attention")


def memory_spans():
    """Every ``encode`` call inside a profiler span named "encode", and
    every cross-attention projection and attention (``cross_kv``,
    ``cross_attention_apply``) inside one named "cross_attention"."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT
    return profiler_spans([(TT, "encode", "encode"),
                           (L, "cross_kv", "cross_attention"),
                           (L, "cross_attention_apply", "cross_attention")])


def scope_labels(events):
    """{correlation id: span} of every host op inside a MEMORY_SCOPES span
    on its thread (a ``by_op`` of ``profile_device_ms``)."""
    import bisect
    spans = {}
    for ev in events:
        if ev.device_type().name == "CPU" and ev.name() in MEMORY_SCOPES:
            spans.setdefault(ev.start_thread_id(), []).append(
                (ev.start_ns(), ev.end_ns(), ev.name()))
    starts = {}
    for th, v in spans.items():
        v.sort()
        starts[th] = [a for a, _, _ in v]
    label = {}
    for ev in events:
        th = ev.start_thread_id()
        if ev.device_type().name != "CPU" or th not in spans:
            continue
        i = bisect.bisect_right(starts[th], ev.start_ns()) - 1
        if i >= 0 and spans[th][i][1] >= ev.end_ns():
            label[ev.correlation_id()] = spans[th][i][2]
    return label


def memory_input(cfg, B, n, seed):
    """The family's stub memory input, 0.1 * normal in the config's dtype
    on the card, as the reference's launchers draw it: frames (B, n,
    encoder d_model) or projected image embeddings (B, n, d_model)."""
    import torch
    from repro_torch.models import layers as L
    d = cfg.encoder.d_model if cfg.encoder is not None else cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, n, d, generator=g, device="cuda")
    return (0.1 * x).to(L.torch_dtype(cfg.dtype))


def memory_launches(cfg, passes):
    """The serving kernels' launches of ``passes`` forward passes of a
    dense decoder with cross blocks (the first a prefill) and of one
    encoder run: each layer's pre-attention norm and fused residual norm,
    each cross block's norm_x, the final norm; a SwiGLU a layer; the flash
    prefill, then a decode a layer a step. The encoder's non-causal
    attention and every cross-attention are plain, as in the reference."""
    L = cfg.n_layers
    n_cross = sum(s.cross_attn for s in cfg.layers)
    norms, swiglu = (2 * L + n_cross + 1) * passes, L * passes
    if cfg.encoder is not None:
        norms += 2 * cfg.encoder.n_layers + 1
        swiglu += cfg.encoder.n_layers
    return want_launches(flash_attention=L, flash_decode=L * (passes - 1),
                         rmsnorm_residual=norms, swiglu=swiglu)


def check_solo_rows(label, params, cfg, prompts, lens, out, memory_of):
    """Rows 0 and B - 1 of a batched generate against the same row alone,
    its memory computed alone (``memory_of(row)``), its prompt left-padded
    by its batch pad modulo KEY_TILE (unpadded where that pad is a
    multiple of the tile): the kernels tile a row's keys from slot 0, so
    pads that agree modulo the tile put every real key at the same column
    of its tile (``csrc/flash_attention.cu``'s BK). A row whose pad is not
    a multiple of the tile is also run unpadded, and whether that run
    equals the batch is printed."""
    from repro_torch.serving import generate
    P, n = prompts.shape[1], out.shape[1] - prompts.shape[1]
    for b in (0, len(lens) - 1):
        Lb = lens[b]
        width = Lb + (P - Lb) % KEY_TILE       # its pad modulo the tile
        runs = [(width, "alone" + (f", left-padded to {width}"
                                   if width > Lb else " unpadded"))]
        if width > Lb:
            runs.append((Lb, "alone unpadded (not a gate)"))
        for w, what in runs:
            kw = dict(prompt_lens=[Lb]) if w > Lb else {}
            solo = generate(params, cfg, prompts[b:b + 1, P - w:],
                            memory=memory_of(b), max_new_tokens=n, **kw)
            solo, got = solo[0, w:].tolist(), out[b, P:].tolist()
            same = solo == got
            log(f"  {label} row {b} (prompt {Lb}, pad {P - Lb}) {what}: "
                f"{'equal' if same else 'DIFFERENT'}; batch {got[:8]}... "
                f"solo {solo[:8]}...")
            if not same and w == width:
                raise AssertionError(f"{label} row {b} differs from its "
                                     f"run alone")


def phase_memory_serve(arch):
    """Phases 25 and 27: full-width ``generate(memory=)`` in bf16 (random
    weights from SERVE_SEED), greedy, 32 new tokens, B=8. seamless: the
    memory is ``encode`` of ENCDEC_FRAMES stub frames (0.1 * normal), the
    prompts left-padded to ENCDEC_P (ENCDEC_LENS); llama-vision: 1600
    stub image embeddings, the prompts of phase 7. The launch counters
    must show exactly ``memory_launches`` for the encoder and the
    generate, nothing else; a second run gives the same memory and tokens
    bit for bit; rows 0 and 7 equal their runs alone
    (``check_solo_rows``). Encoder ms, prefill ms (the cross cache's
    projection and the fused prefill), decode ms a step, peak memory; a
    profiled prefill and decode step, and one profiled encode + generate,
    by family (the encoder's and the cross-attentions' cuBLAS and other
    kernels named by their span). Returns the measurements."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import generate, make_serve_step, prefill_fused
    cfg = get_config(arch)
    params = model_params(cfg)
    if cfg.encoder is not None:
        P, lens, n_mem = ENCDEC_P, ENCDEC_LENS, ENCDEC_FRAMES
    else:
        P, lens, n_mem = SERVE_P, PROMPT_LENS, cfg.vision.n_image_tokens
    prompts = ragged_prompts(cfg.vocab_size, SERVE_SEED + 1, P, lens)
    inputs = memory_input(cfg, SERVE_B, n_mem, SERVE_SEED + 2)

    @torch.no_grad()
    def memory_of(x):
        return TT.encode(params, cfg, x, use_kernels=True) \
            if cfg.encoder is not None else x

    n = SERVE_NEW
    kw = dict(max_new_tokens=n, prompt_lens=lens)
    generate(params, cfg, prompts, memory=memory_of(inputs), **kw)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    memory = memory_of(inputs)
    out = generate(params, cfg, prompts, memory=memory, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = memory_launches(cfg, n)
    log(f"  {cfg.name}: memory {tuple(memory.shape)}, prompts "
        f"{tuple(prompts.shape)} ragged {lens}; encode + generate: out "
        f"{tuple(out.shape)} wall {wall * 1e3:.1f} ms "
        f"({SERVE_B * n / wall:.1f} new tokens/s end to end), peak memory "
        f"{peak:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"{arch} launches {launches}, want {want}")
    if tuple(out.shape) != (SERVE_B, P + n) or \
            not bool((out[:, P:] < cfg.vocab_size).all()) or \
            not bool((out[:, P:] >= 0).all()) or \
            not torch.equal(out[:, :P], prompts):
        raise AssertionError("generate's output is malformed")
    again_mem = memory_of(inputs)
    again = generate(params, cfg, prompts, memory=again_mem, **kw)
    same = torch.equal(again, out) and torch.equal(again_mem, memory)
    log(f"  a second encode + generate: memory and tokens "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("two runs gave different memories or tokens")
    del again_mem, again
    check_solo_rows(cfg.name, params, cfg, prompts, lens, out,
                    lambda b: memory_of(inputs[b:b + 1]))

    # encoder, prefill and decode times (CUDA events, warm)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    off = serve_offsets(lens, P)
    enc, pre = [], []
    for _ in range(3):
        start.record()
        memory = memory_of(inputs)
        end.record()
        torch.cuda.synchronize()
        enc.append(start.elapsed_time(end))
        cache = TT.init_cache(cfg, SERVE_B, P + n, memory_len=n_mem)
        start.record()
        TT.build_cross_cache(params, cfg, memory, cache)
        last, cache = prefill_fused(params, cfg, prompts, cache, offsets=off)
        end.record()
        torch.cuda.synchronize()
        pre.append(start.elapsed_time(end))
    step = make_serve_step(cfg)
    tok = last.argmax(-1)[:, None]
    start.record()
    for i in range(n - 1):
        tok, cache = step(params, cache, tok, P + i, offsets=off)
    end.record()
    torch.cuda.synchronize()
    dec = start.elapsed_time(end) / (n - 1)
    enc_ms = sorted(enc)[1] if cfg.encoder is not None else 0.0
    prefill_ms = sorted(pre)[1]
    log(f"  encoder {enc_ms:.2f} ms for {SERVE_B}x{n_mem} frames; prefill "
        f"(cross cache + fused prefill) {prefill_ms:.2f} ms (runs "
        f"{[round(t, 2) for t in pre]}) for {SERVE_B}x{P} tokens; decode "
        f"{dec:.3f} ms a step ({SERVE_B / dec * 1e3:.1f} tokens/s at "
        f"B={SERVE_B})")

    def prefill_call():
        c = TT.init_cache(cfg, SERVE_B, P + n, memory_len=n_mem)
        TT.build_cross_cache(params, cfg, memory, c)
        return prefill_fused(params, cfg, prompts, c, offsets=off)

    with memory_spans():
        breakdown = {
            "decode step": family_profile("decode step", lambda: step(
                params, cache, tok, P + n - 2, offsets=off),
                by_op=scope_labels),
            "prefill": family_profile("prefill", prefill_call,
                                      by_op=scope_labels)}
        del cache
        busy, kernels = profile_device_ms(
            lambda: generate(params, cfg, prompts, memory=memory_of(inputs),
                             **kw), reps=1, warm=False, by_op=scope_labels)
    fam, calls = by_family(kernels)
    log(f"  profiled encode + generate: device busy {busy or 0.0:.2f} ms of "
        f"{wall * 1e3:.1f}; device ms by family "
        f"{ {k: round(v, 3) for k, v in sorted(fam.items())} } (kernels "
        f"{dict(sorted(calls.items()))})")
    del params, memory, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_ms": wall * 1e3, "encode_ms": enc_ms,
            "prefill_ms": prefill_ms, "decode_ms": dec, "peak_gib": peak,
            "breakdown": breakdown, "families": fam, "calls": calls, "P": P}


def phase_memory_train(arch, layers=None):
    """Phases 26 and 28: a training step at full width with the memory in
    the batch (seamless: TRAIN_T // 4 = 128 stub frames through the
    encoder; llama-vision: 1600 stub image embeddings), on B=8 x T=512
    rows of token_lm, as ``train_steps`` (random weights from SERVE_SEED).
    ``layers`` cuts the depth. A step must launch exactly,
    forward and backward, a fused norm for each layer's two norms, each
    cross block's norm_x, the final norm and the encoder's 2 a layer + 1;
    a SwiGLU a layer (the encoder's too); a RoPE flash attention a decoder
    layer; nothing else (the encoder's attention and every
    cross-attention are plain)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_sequences, token_lm
    full = get_config(arch)
    cfg = full
    if layers is not None:
        cfg = dataclasses.replace(
            full, body_repeats=layers // len(full.body_pattern))
    L, Le = cfg.n_layers, cfg.encoder.n_layers if cfg.encoder else 0
    n_cross = sum(s.cross_attn for s in cfg.layers)
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=TRAIN_B * TRAIN_T), TRAIN_T)
    batch = {"tokens": torch.as_tensor(rows, device="cuda").long()}
    if cfg.encoder is not None:
        batch["frames"] = memory_input(
            cfg, TRAIN_B, TRAIN_T // cfg.encoder.frame_ratio, TRAIN_SEED)
    else:
        batch["image_embeds"] = memory_input(
            cfg, TRAIN_B, cfg.vision.n_image_tokens, TRAIN_SEED)
    norms = 2 * L + n_cross + 1 + (2 * Le + 1 if Le else 0)
    want = want_launches(rmsnorm_residual=norms,
                         rmsnorm_residual_backward=norms, swiglu=L + Le,
                         swiglu_backward=L + Le, flash_attention_rope=L,
                         flash_attention_backward=L)
    mem = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
    log(f"train {cfg.name}: {L} of {full.n_layers} decoder layers "
        f"({n_cross} cross), encoder {Le} layers, memory {mem}")
    # the parameters are held by the steps alone
    out = train_steps(f"{cfg.name} ({L} of {full.n_layers} layers)", cfg,
                      model_params(cfg), batch, want, by_op=scope_labels,
                      spans=memory_spans)
    out["layers"] = L
    return out


def phase_jamba():
    """Phase 29: jamba-v0.1-52b in bf16 at full width, the depth cut to
    JAMBA_LAYERS (2 of 4 periods: 14 Mamba and 2 attention layers, 8 MoE
    and 8 dense feed-forwards; random weights from SERVE_SEED). ``generate``
    as phase 7 (the prompts of PROMPT_LENS, 32 greedy tokens): exactly a
    flash prefill and a decode a step for each attention layer, two
    mamba_chunk launches for each Mamba layer (none in decode), 2L + 1
    fused norms and a SwiGLU for each dense layer a pass, nothing else; a
    second run bit-equal; the dropped shares at prefill and decode;
    prefill ms, decode ms a step, peak memory; a profiled prefill, decode
    step and generate by family (the MoE layer's ops as phase 21's). Then
    ContinuousEngine on the first MOE_ENGINE_REQUESTS requests of
    ENGINE_TRACE with phase 10's slots and pages: paged attention for the
    attention layers and SSM states for the Mamba layers in one engine;
    every request completes; exactly a paged decode an attention layer a
    step, a flash prefill an attention layer and one mamba_chunk a 256
    prompt tokens a Mamba layer an admission, the norms and SwiGLUs a
    pass; useful tokens/s and a profiled run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as TB
    from repro_torch.models import transformer as TT
    from repro_torch.models.ssm import DEFAULT_CHUNK
    from repro_torch.serving import (ContinuousEngine, generate,
                                     make_serve_step, poisson_trace,
                                     prefill_fused)
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(
        full, body_repeats=JAMBA_LAYERS // len(full.body_pattern))
    params = model_params(cfg)
    L, n = cfg.n_layers, SERVE_NEW
    n_attn = sum(s.mixer == "attn" for s in cfg.layers)
    n_ssm = sum(s.mixer == "ssm" for s in cfg.layers)
    n_dense = sum(s.ff == "dense" for s in cfg.layers)

    def chunks(P):
        return -(-P // DEFAULT_CHUNK)

    prompts = ragged_prompts(cfg.vocab_size, SERVE_SEED + 1)
    kw = dict(max_new_tokens=n, prompt_lens=PROMPT_LENS)
    generate(params, cfg, prompts, **kw)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = want_launches(flash_attention=n_attn,
                         flash_decode=n_attn * (n - 1),
                         mamba_chunk=n_ssm * chunks(SERVE_P),
                         rmsnorm_residual=(2 * L + 1) * n,
                         swiglu=n_dense * n)
    log(f"  generate ({L} of {full.n_layers} layers: {n_ssm} mamba, "
        f"{n_attn} attention, {L - n_dense} MoE): out {tuple(out.shape)} "
        f"wall {wall * 1e3:.1f} ms ({SERVE_B * n / wall:.1f} new tokens/s "
        f"end to end), peak memory {peak:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"{JAMBA_ARCH} launches {launches}, want {want}")
    if tuple(out.shape) != (SERVE_B, SERVE_P + n) or \
            not bool((out[:, SERVE_P:] < cfg.vocab_size).all()) or \
            not bool((out[:, SERVE_P:] >= 0).all()) or \
            not torch.equal(out[:, :SERVE_P], prompts):
        raise AssertionError("generate's output is malformed")
    with drops_counted({}, SERVE_P) as counts:
        again = generate(params, cfg, prompts, **kw)
    same = torch.equal(again, out)
    shares = drop_shares(counts)
    log(f"  a second generate: tokens {'bit-equal' if same else 'DIFFERENT'}"
        f"; dropped assignments: prefill {shares['prefill']:.4f} (C = "
        f"{cfg.moe.tokens_capacity(SERVE_P)} a sequence of {SERVE_P}), decode "
        f"{shares['decode']:.4f} (C = {cfg.moe.tokens_capacity(SERVE_B)}: "
        f"the {SERVE_B} rows pool)")
    if not same:
        raise AssertionError("two generate runs gave different tokens")

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
    with moe_spans():
        breakdown = {
            "decode step": family_profile("decode step", lambda: step(
                params, cache, tok, SERVE_P + n - 2, offsets=off),
                by_op=MOE_LABELS),
            "prefill": family_profile("prefill", lambda: prefill_fused(
                params, cfg, prompts,
                TT.init_cache(cfg, SERVE_B, SERVE_P + n), offsets=off),
                by_op=MOE_LABELS)}
        del cache
        busy, kernels = profile_device_ms(
            lambda: generate(params, cfg, prompts, **kw), reps=1, warm=False,
            by_op=MOE_LABELS)
    fam, calls = by_family(kernels)
    log(f"  profiled generate: device busy {busy or 0.0:.2f} ms of "
        f"{wall * 1e3:.1f}; device ms by family "
        f"{ {k: round(v, 3) for k, v in sorted(fam.items())} } (kernels "
        f"{dict(sorted(calls.items()))})")
    serve = {"launches": launches, "wall_ms": wall * 1e3,
             "prefill_ms": prefill_ms, "decode_ms": dec, "peak_gib": peak,
             "drop_shares": shares, "breakdown": breakdown,
             "families": fam, "calls": calls}
    torch.cuda.empty_cache()

    # the engine: pages for the attention layers, states for the SSM ones
    trace = poisson_trace(cfg, **ENGINE_TRACE)[:MOE_ENGINE_REQUESTS]
    ekw = dict(num_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
               layout="paged", page_size=ENGINE_PAGE)
    log(f"engine {cfg.name} ({L} layers) bf16: {ekw}, default pool; the "
        f"first {len(trace)} requests of {ENGINE_TRACE}: prompts "
        f"{[len(r.prompt) for r in trace]}, "
        f"{sum(r.max_new_tokens for r in trace)} tokens asked for")
    eng = ContinuousEngine(params, cfg, **ekw)
    kinds = {k for _, c in TB.each_layer(eng.cache, cfg) for k in c}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    comps = eng.run(trace)
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    elaunches = all_launches()
    st = eng.stats()
    epeak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, admits = int(st["steps"]), len(trace)
    ewant = want_launches(
        flash_decode_paged=n_attn * steps, flash_attention=n_attn * admits,
        mamba_chunk=n_ssm * sum(chunks(len(r.prompt)) for r in trace),
        rmsnorm_residual=(2 * L + 1) * (steps + admits),
        swiglu=n_dense * (steps + admits))
    log(f"  {ENGINE_SLOTS} slots, cache kinds {sorted(kinds)}: "
        f"{ {k: round(v, 3) for k, v in st.items()} }; wall {ewall:.2f} s; "
        f"peak memory {epeak:.2f} GiB; launches {elaunches}")
    toks = {i: c.tokens for i, c in comps.items()}
    bad = [r.id for r in trace if len(toks.get(r.id, ())) != r.max_new_tokens
           or not all(0 <= t < cfg.vocab_size for t in toks[r.id])]
    if sorted(toks) != [r.id for r in trace] or bad:
        raise AssertionError(f"requests incomplete or out of vocabulary: "
                             f"{bad}")
    if kinds != {"attn", "ssm"}:
        raise AssertionError(f"engine cache kinds {kinds}")
    if elaunches != ewant:
        raise AssertionError(f"engine launches {elaunches}, want {ewant}")
    del eng
    torch.cuda.empty_cache()
    for attempt in range(2):
        eng = ContinuousEngine(params, cfg, **ekw)
        reset_all_launches()
        ebusy, ekernels = profile_device_ms(lambda: eng.run(trace), reps=1,
                                            warm=False, host=False, tries=1)
        efam, ecalls = by_family(ekernels)
        paged = all_launches()["flash_decode_paged"]
        del eng
        if ecalls.get("flash_decode_paged") == paged:
            break
        msg = (f"the profile holds {ecalls.get('flash_decode_paged')} paged "
               f"decode kernels, the counter {paged}")
        if attempt == 1:
            raise AssertionError(msg)
        log(f"  {msg}; profiling the run again")
    log(f"  profiled run: device busy {ebusy or 0.0:.1f} ms (idle share "
        f"{1 - (ebusy or 0.0) / 1e3 / st['elapsed_s']:.3f} of the unprofiled "
        f"run's {st['elapsed_s']:.2f} s); device ms by family "
        f"{ {k: round(v, 3) for k, v in sorted(efam.items())} }")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    engine = {"stats": st, "wall_s": ewall, "peak_gib": epeak,
              "launches": elaunches, "families": efam, "calls": ecalls}
    return serve, engine


def phase_new_cuda_vs_cpu():
    """Phase 30: the six new configurations reduced, in f32: the same
    parameters on the card (kernels) and the CPU (the plain model path,
    ``use_kernels=False``), the memory from the same input on each
    (seamless: encoded there; llama-vision: the embeddings): jamba's
    ragged prefill routing equal layer by layer first (the near-tie rule
    of phase 24); the ragged prefill's logits (its cross cache built from
    the memory) within TOL; greedy tokens of ragged prompts equal, past
    gemma3's window of 16; one make_lm_train_step step (its memory input
    in the batch): loss within LOSS_TOL, parameters within TOL."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.serving import generate
    from repro_torch.train.trainer import make_lm_train_step
    for name in NEW_REDUCED:
        cfg = dataclasses.replace(get_config(name), dtype="float32")
        p_cpu = TT.init_params(3, cfg, device="cpu")
        p_gpu = tree.map(lambda t: t.cuda(), p_cpu)
        P, lens, T = 40, (40, 23, 9, 1), 64
        g = torch.Generator().manual_seed(4)
        prompts = torch.randint(0, cfg.vocab_size, (len(lens), P),
                                generator=g)
        tokens = torch.randint(0, cfg.vocab_size, (4, T), generator=g)
        mem_key, n_mem = None, 0
        if cfg.encoder is not None:
            mem_key, n_mem = "frames", TT.memory_len(cfg, T)
            width = cfg.encoder.d_model
        elif cfg.vision is not None:
            mem_key, n_mem = "image_embeds", TT.memory_len(cfg, T)
            width = cfg.d_model
        mem_in = None if mem_key is None else \
            0.1 * torch.randn(len(lens), n_mem, width, generator=g)
        lb = LargeBatchConfig(batch_size=4, base_batch_size=4, grad_clip=1.0)
        regime = Regime(base_lr=0.05, total_steps=10, drop_every=10)
        outs, logits, steps, routes = {}, {}, {}, {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            kern = dev == "cuda"
            memory = None
            batch = {"tokens": tokens.to(dev)}
            if mem_key is not None:
                batch[mem_key] = mem_in.to(dev)
                with torch.no_grad():
                    memory = TT.get_memory(p, cfg, batch, use_kernels=kern)
            outs[dev] = generate(p, cfg, prompts, max_new_tokens=12,
                                 prompt_lens=lens, memory=memory,
                                 use_kernels=kern, device=dev).cpu()
            cache = TT.init_cache(cfg, len(lens), P + 1, memory_len=n_mem,
                                  device=dev, layout="head" if kern
                                  else "seq")
            if memory is not None:
                TT.build_cross_cache(p, cfg, memory, cache)
            off = torch.tensor([P - n_ for n_ in lens], device=dev,
                               dtype=torch.int32)
            with routing_recorded([]) as routes[dev]:
                lg, _ = TT.prefill_forward(p, cfg, prompts.to(dev), cache,
                                           use_kernels=kern, offsets=off)
            logits[dev] = lg.cpu()
            step = make_lm_train_step(cfg, lb, regime, use_kernels=kern)
            p2, _, m = step(p, sgd.init(p), batch, 0)
            steps[dev] = (float(m["loss"]),
                          [t.cpu() for t in tree.leaves(p2)])
        log(f"new configs cuda vs cpu: {cfg.name} f32 ({cfg.n_layers} "
            f"layers), B={len(lens)} P={P} ragged {lens}, 12 new tokens, "
            f"memory {mem_key} x{n_mem}; one train step B=4 T={T}: loss "
            f"{steps['cuda'][0]:.7f} vs {steps['cpu'][0]:.7f}")
        if cfg.moe is not None:
            same_routing(f"{cfg.name} prefill routing", routes["cuda"],
                         routes["cpu"])
        check_close("prefill logits", logits["cuda"], logits["cpu"], TOL)
        same = torch.equal(outs["cuda"], outs["cpu"])
        log(f"  greedy tokens {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{cfg.name}: greedy tokens differ between "
                                 f"cuda and cpu")
        check_close("train step loss", torch.tensor(steps["cuda"][0]),
                    torch.tensor(steps["cpu"][0]), LOSS_TOL)
        check_close("train step params",
                    torch.cat([t.reshape(-1) for t in steps["cuda"][1]]),
                    torch.cat([t.reshape(-1) for t in steps["cpu"][1]]), TOL)


def memory_kernel_line(results):
    """The slice's kernels: device ms and launches in each profiled run
    (encode + generate of seamless and llama-vision, jamba's generate and
    engine run; the train steps' training kernels)."""
    parts = []
    serve_fams = {"rmsnorm_residual": "rmsnorm_residual",
                  "swiglu": "swiglu", "flash_attention": "flash_fwd",
                  "flash_decode": "flash_decode",
                  "flash_decode_paged": "flash_decode_paged",
                  "mamba_chunk": "mamba_chunk_fwd"}
    train_fams = {"rmsnorm_residual": "rmsnorm_residual", "swiglu": "swiglu",
                  **{name: fam for name, (*_, fam, _) in
                     TRAIN_KERNELS.items()}}
    for label, run in results.items():
        fams = train_fams if "train" in label else serve_fams
        src = run["breakdown"] if "train" in label else run
        rows = [f"{name} {src['families'].get(fam, 0.0):.3f} ms "
                f"{run['launches'][name]} launches"
                for name, fam in fams.items() if run["launches"][name]]
        parts.append(f"{label}: " + ", ".join(rows))
    log("memory and hybrid path kernels (device ms and launches): "
        + "; ".join(parts))


def memory_summary(runs):
    """Slice 8's end-to-end numbers and its kernels' line."""
    for label in ("seamless generate", "llama-vision generate"):
        r = runs[label]
        log(f"serve {label.split()[0]} (B={SERVE_B}, P={r['P']} ragged, "
            f"{SERVE_NEW} new tokens): encode + generate {r['wall_ms']:.1f} "
            f"ms, encoder {r['encode_ms']:.2f} ms, prefill "
            f"{r['prefill_ms']:.2f} ms, decode {r['decode_ms']:.3f} ms a "
            f"step, peak {r['peak_gib']:.2f} GiB")
    for label in ("seamless train", "llama-vision train"):
        r = runs[label]
        log(f"train {label.split()[0]} ({r['layers']} decoder layers, bf16, "
            f"B={TRAIN_B}, T={TRAIN_T}): median step {r['step_ms']:.1f} ms, "
            f"{r['tok_s']:.0f} tokens/s, peak {r['peak_gib']:.2f} GiB")
    js, je = runs["jamba generate"], runs["jamba engine"]
    log(f"serve {JAMBA_ARCH} ({JAMBA_LAYERS} layers, B={SERVE_B}, "
        f"P={SERVE_P} ragged, {SERVE_NEW} new tokens): generate "
        f"{js['wall_ms']:.1f} ms, prefill {js['prefill_ms']:.2f} ms, decode "
        f"{js['decode_ms']:.3f} ms a step, peak {js['peak_gib']:.2f} GiB, "
        f"dropped assignments "
        f"{ {k: round(v, 4) for k, v in js['drop_shares'].items()} }; "
        f"engine ({MOE_ENGINE_REQUESTS} requests, {je['stats']['steps']:.0f} "
        f"steps) {je['stats']['useful_tok_s']:.1f} useful tokens/s, peak "
        f"{je['peak_gib']:.2f} GiB")
    memory_kernel_line(runs)


# ---------------------------------------------------------------------------
# slice 9: the parallel layer, ranks as processes that share the one card
# ---------------------------------------------------------------------------

MESH_DEVICE = "cuda"
MESH_TIMEOUT = 420             # seconds one spawn of ranks may take
MESH_DP_STEPS = 5              # timed, after one warm step (phase 31)
MESH_LM_STEPS = 3              # timed, after one warm step (phase 32)
MESH_EP_STEPS = 2              # timed, after one warm step (phase 33)
MESH_EP_B = 4                  # phase 33's rows of TRAIN_T (see below)
MESH_LM_LAYERS = 8             # qwen3-1.7b cut from 28 layers, as phase 10
MESH_EP_LAYERS = 2             # qwen2-moe-a2.7b cut from 24, as phase 23
MESH_LM_KINDS = {      # (arch, layers, tp, fsdp, timed steps, global rows)
    "tp_fsdp": (SERVE_ARCH, MESH_LM_LAYERS, True, True, MESH_LM_STEPS,
                TRAIN_B),
    # experts over "model" (30 of 60 a rank), and FSDP over "data": pure
    # EP keeps the 1.24 B replicated parameters whole on every rank, ~17.5
    # GB a rank at the update (weights, gradients, the old and the new f32
    # momentum), past one card for four ranks; with FSDP a rank peaks at
    # ~12.7 GiB, and at 8 rows one rank also held 5.6 GiB of freed blocks
    # and four overflowed the card: 4 rows, and expandable segments
    # (spawn_ranks)
    "ep": (MOE_ARCH, MESH_EP_LAYERS, False, True, MESH_EP_STEPS,
           MESH_EP_B),
}
MESH_PARITY_STEPS = 2
MESH_PARITY_MODES = {          # (model, mesh, tp, fsdp, optimizer)
    **{f"{m}_{o}": ("dense", "data" if m == "dp" else "2d", "tp" in m,
                    "fsdp" in m, o)
       for m in ("dp", "tp", "fsdp", "tp_fsdp") for o in ("sgd", "adam")},
    "ep_sgd": ("moe", "2d", False, False, "sgd"),
}
MESH_PARITY_ARCHS = {"dense": SERVE_ARCH + "-reduced",
                     "moe": MOE_ARCH + "-reduced"}
MESH_PARITY_LR = {"sgd": 0.05, "adam": 1e-3}
MESH_SWEEP = dict(steps=2, large_batch=64, small_batch=32, ghost=16)
ACC_TOL = 0.02     # sweep accuracies: read through the running statistics
DROP_TOL = 0.005   # dropped share past the first MoE layer (see phase 33)
MESH_KERNELS = ("gbn_forward", "gbn_backward", "rmsnorm_residual",
                "rmsnorm_residual_backward", "swiglu", "swiglu_backward",
                "flash_attention_rope", "flash_attention_backward")
MESH_FAMILIES = {"gbn_forward": "gbn_fwd", "gbn_backward": "gbn_bwd",
                 "rmsnorm_residual": "rmsnorm_residual",
                 "rmsnorm_residual_backward": "rmsnorm_residual_bwd",
                 "swiglu": "swiglu", "swiglu_backward": "swiglu_bwd",
                 "flash_attention_rope": "flash_fwd",
                 "flash_attention_backward": "flash_bwd"}


def mesh_sync():
    import torch
    if MESH_DEVICE == "cuda":
        torch.cuda.synchronize()


def rank_setup():
    """A rank's process: every rank computes on the one card (device 0);
    TF32 off and deterministic cuDNN, as in the parent."""
    import torch
    from repro_torch.device import set_precision
    set_precision()
    if MESH_DEVICE == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()


def rank_peak_gib() -> float:
    import torch
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if MESH_DEVICE == "cuda" else 0.0)


def rank_dump(out, rank, res) -> None:
    import pickle
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(label, fn, world, *args):
    """``fn(rank, out, *args)`` on ``world`` spawned ranks (gloo, a
    ``file://`` store, MESH_TIMEOUT); a rank that fails fails the phase.
    Returns every rank's pickled results."""
    import os
    import pickle
    import torch
    from repro_torch.launch.spawn import run_ranks
    if MESH_DEVICE == "cuda":
        log(f"  {label}: this process holds "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
            f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved) of the "
            f"card beside the ranks")
    # the ranks' allocators grow segments in place: four ranks' freed
    # blocks would otherwise strand GiBs of the one card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as out:
        run_ranks(fn, world, (out,) + tuple(args), timeout=MESH_TIMEOUT)
        res = []
        for r in range(world):
            with open(Path(out) / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
    log(f"  {label}: {world} ranks ran {time.perf_counter() - t0:.1f} s "
        f"(spawn and set-up included)")
    return res


def mesh_family(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gbn_bwd", "gbn_dx", "gbn_sum_ghosts")):
        return "gbn_bwd"
    return "gbn_fwd" if "gbn" in n else family(name)


def rank_profile(fn):
    """One call of ``fn`` (a step: every rank calls it alike) under the
    profiler in this rank: device ms and kernels by family. One window
    only: a second call on one rank alone would wait for the others' in
    its collectives. Ranks share the card, so a kernel's device time can
    hold time the card gave another rank's kernels."""
    from repro_torch.launch import collectives as C

    def aligned():
        # every rank enters the step together: a collective timed inside
        # waits for no rank's profiler start-up
        C.barrier()
        fn()

    busy, kernels = profile_device_ms(aligned, reps=1, warm=False,
                                      host=False, tries=1)
    fam, calls = {}, {}
    for t, count, name in kernels:
        f = mesh_family(name)
        fam[f] = fam.get(f, 0.0) + t
        calls[f] = calls.get(f, 0) + count
    return {"busy_ms": busy, "families": fam, "calls": calls}


def dp_recipe():
    from repro_torch.core import Regime, presets
    lb = presets(BATCH, 128, GHOST)["LB+LR+GBN+RA"]
    return lb, lb.build_regime(Regime(base_lr=0.1, total_steps=20,
                                      drop_every=3))


def dp_batch():
    """One global batch of BATCH rows of 32 x 32 x 3, the same in every
    process (numpy from a seed)."""
    import torch
    from repro_torch.data import teacher_classification
    data = teacher_classification(0, n_train=BATCH, n_test=16,
                                  input_shape=(32, 32, 3))
    return (torch.as_tensor(data.x_train, device=MESH_DEVICE),
            torch.as_tensor(data.y_train, device=MESH_DEVICE).long())


def flat_leaves(t):
    import torch
    from repro_torch import tree
    return torch.cat([a.detach().float().reshape(-1)
                      for a in tree.leaves(t)])


def dp_vision_rank(rank, out):
    """Phase 31's rank: ResNet44 at published width on its 2048 rows."""
    import torch
    rank_setup()
    from repro_torch.configs import RESNET44_CIFAR10 as cfg
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import gbn as K
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models.cnn import model_fns
    from repro_torch.optim import sgd
    from repro_torch.train.data_parallel import make_dp_vision_train_step
    mesh = make_data_mesh(device=MESH_DEVICE)
    lb, regime = dp_recipe()
    init, apply = model_fns(cfg)
    params, state = init(0, cfg, MESH_DEVICE)
    opt = sgd.init(params)
    x, y = dp_batch()
    xy = shard_batch({"x": x, "y": y}, mesh)
    step = make_dp_vision_train_step(apply, cfg, lb, regime, mesh,
                                     use_kernels=True)
    res = {k: [] for k in ("losses", "ms", "launches", "calls", "bytes",
                           "flat", "states")}
    # dp_gbn_forward through B1 on this rank's rows (its own data): every
    # rank's statistics gathered rank-major, its own against gbn_ref
    from repro_torch.kernels import ref
    from repro_torch.train.data_parallel import dp_gbn_forward
    g = torch.Generator(device=MESH_DEVICE).manual_seed(11 + rank)
    xs = torch.randn((BATCH // 2, 8, 8, 16), generator=g,
                     device=MESH_DEVICE)
    gamma = torch.linspace(0.5, 1.5, 16, device=MESH_DEVICE)
    beta = torch.linspace(-1.0, 1.0, 16, device=MESH_DEVICE)
    K.reset_launches()
    yk, mu, var = dp_gbn_forward(xs, gamma, beta, mesh,
                                 ghost_batch_size=GHOST, use_kernels=True)
    G = xs.shape[0] // GHOST
    yr, mur, varr = ref.gbn_ref(xs.reshape(G, -1, 16), gamma, beta)
    res["dp_gbn"] = {
        "launches": dict(K.launches),
        "err": max(max_err(yk, yr.reshape(yk.shape)),
                   max_err(mu[rank * G:(rank + 1) * G], mur),
                   max_err(var[rank * G:(rank + 1) * G], varr)),
        "mu": mu.cpu().numpy(), "var": var.cpu().numpy(),
        "own_mu": mur.cpu().numpy()}
    for i in range(1 + MESH_DP_STEPS):
        K.reset_launches()
        C.reset_stats()
        mesh_sync()
        t0 = time.perf_counter()
        params, state, opt, m = step(params, state, opt, xy["x"], xy["y"], i)
        mesh_sync()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["launches"].append(dict(K.launches))
        res["calls"].append(C.STATS["calls"])
        res["bytes"].append(C.STATS["bytes"])
        res["losses"].append(float(m["loss"]))
        res["flat"].append(flat_leaves(params).cpu().numpy())
        if i < 2:
            res["states"].append(flat_leaves(state).cpu().numpy())
    res["peak_gib"] = rank_peak_gib()
    res["rows"] = xy["x"].shape[0]
    # one more step, profiled, its all-reduce timed alone
    C.reset_stats()
    with C.timed():
        res["profile"] = rank_profile(lambda: step(
            params, state, opt, xy["x"], xy["y"], 1 + MESH_DP_STEPS))
    res["allreduce_ms"], res["staged_bytes"] = (C.STATS["ms"],
                                                C.STATS["staged_bytes"])
    rank_dump(out, rank, res)


def phase_mesh_dp():
    """Phase 31: data-parallel ResNet44 over 2 ranks sharing the card, global
    B=4096 (2048 a rank, ghosts of 128, LB+LR+GBN+RA), 1 warm and
    MESH_DP_STEPS timed steps. Gates: exactly 43 + 43 GBN launches a step
    on each rank; the ranks' parameters bit-identical after every step;
    in f32, against the single-process card step on the same global batch
    from the same parameters, the loss of the first three steps within
    LOSS_TOL and the parameters after three steps within TOL; the running
    statistics after steps 1 and 2 the mean of the single-process step's
    states over each rank's shard (each rank folds its own ghosts)."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import RESNET44_CIFAR10 as cfg
    from repro_torch.models.cnn import model_fns
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import (make_vision_loss_fn,
                                           make_vision_train_step)
    init, apply = model_fns(cfg)
    params, state = init(0, cfg, MESH_DEVICE)
    lb, regime = dp_recipe()
    x, y = dp_batch()
    half = BATCH // 2
    step = make_vision_train_step(apply, cfg, lb, regime, use_kernels=True)
    loss_fn = make_vision_loss_fn(apply, cfg, lb, use_kernels=True)
    p, s, o, s_dp = params, state, sgd.init(params), state
    want_losses, want_states = [], []
    for i in range(3):
        if i < 2:
            with torch.no_grad():
                shards = [loss_fn(p, s_dp, x[h * half:(h + 1) * half],
                                  y[h * half:(h + 1) * half])[1][0]
                          for h in range(2)]
            s_dp = tree.map(lambda a, b: a if a.dtype == torch.bool
                            else (a + b) / 2, *shards)
            want_states.append(flat_leaves(s_dp).cpu())
        p, s, o, m = step(p, s, o, x, y, i)
        want_losses.append(float(m["loss"]))
    want_params = flat_leaves(p).cpu()
    del params, state, p, s, o, s_dp, x, y
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn_ranks("phase 31", dp_vision_rank, 2)
    for r, res in enumerate(ranks):
        d = res["dp_gbn"]
        if d["launches"]["gbn_forward"] != 1 or d["err"] > TOL or not (
                np.array_equal(d["mu"], ranks[0]["dp_gbn"]["mu"])
                and np.array_equal(d["var"], ranks[0]["dp_gbn"]["var"])):
            raise AssertionError(f"rank {r}: dp_gbn_forward {d['launches']}"
                                 f", error {d['err']}")
    log(f"  dp_gbn_forward (B1, {BATCH // 2} rows of 8 x 8 x 16 a rank, "
        f"ghost {GHOST}): both ranks' statistics gathered rank-major, each "
        f"rank's own against gbn_ref within "
        f"{max(r['dp_gbn']['err'] for r in ranks):.3e}")
    want = {"gbn_forward": 43, "gbn_backward": 43}
    for r, res in enumerate(ranks):
        if any(l != want for l in res["launches"]):
            raise AssertionError(f"rank {r}: GBN launches a step "
                                 f"{res['launches']}, want {want}")
    for i, (a, b) in enumerate(zip(ranks[0]["flat"], ranks[1]["flat"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"ranks' parameters differ after step {i}")
    for i in range(3):
        check_close(f"dp loss step {i}", torch.tensor(ranks[0]["losses"][i]),
                    torch.tensor(want_losses[i]), LOSS_TOL)
    check_close("dp params after 3 steps",
                torch.as_tensor(ranks[0]["flat"][2]), want_params, TOL)
    for i in range(2):
        for r, res in enumerate(ranks):
            check_close(f"dp running stats r{r} step {i}",
                        torch.as_tensor(res["states"][i]), want_states[i],
                        TOL)
    step_ms = [median(res["ms"][1:]) for res in ranks]
    out = {"step_ms": step_ms, "allreduce_ms": [r["allreduce_ms"]
                                                for r in ranks],
           "bytes": ranks[0]["bytes"][1], "calls": ranks[0]["calls"][1],
           "staged": ranks[0]["staged_bytes"],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "profile": [r["profile"] for r in ranks],
           "launches": ranks[0]["launches"][1]}
    log(f"phase 31 dp {cfg.name} (2 ranks on one card, {ranks[0]['rows']} "
        f"rows a rank, ghost {GHOST}): step ms a rank "
        f"{[[round(t, 1) for t in r['ms']] for r in ranks]} (medians "
        f"{[round(t, 2) for t in step_ms]}); losses {ranks[0]['losses']}; "
        f"all-reduce a step: {out['calls']} call, {out['bytes']} bytes, "
        f"{[round(t, 3) for t in out['allreduce_ms']]} ms (staged "
        f"{out['staged']} bytes); peak "
        f"{[round(g, 2) for g in out['peak_gib']]} GiB; launches a step "
        f"{out['launches']}")
    for r, prof in enumerate(out["profile"]):
        log(f"  profile rank {r}: busy {prof['busy_ms']} ms, by family "
            f"{ {k: round(v, 3) for k, v in prof['families'].items()} }, "
            f"kernels {prof['calls']}")
    return out


def lm_mesh_rank(rank, out, kind):
    """Phases 32 and 33's rank: MESH_LM_KINDS[kind] at published widths
    over the (2 data, 2 model) mesh, bf16, its global rows of TRAIN_T."""
    import torch
    rank_setup()
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import LargeBatchConfig, Regime
    from repro_torch.data import lm_sequences, token_lm
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import MODEL_AXIS, make_2d_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TT
    from repro_torch.optim import sgd
    from repro_torch.train import parallel as PAR
    from repro_torch.train.trainer import make_lm_train_step
    arch, layers, tp, fsdp, timed_steps, n_rows = MESH_LM_KINDS[kind]
    cfg = dataclasses.replace(get_config(arch), body_repeats=layers)
    mesh = make_2d_mesh(device=MESH_DEVICE)
    params = TT.init_params(SERVE_SEED, cfg, MESH_DEVICE)
    lb = LargeBatchConfig(batch_size=n_rows, base_batch_size=n_rows,
                          grad_clip=1.0)
    regime = Regime(base_lr=TRAIN_LR, total_steps=100, drop_every=100)
    step = make_lm_train_step(cfg, lb, regime, use_kernels=True, mesh=mesh,
                              params=params, tp=tp, fsdp=fsdp)
    specs = tree.leaves(step.param_specs)
    res = {"state_bytes": {
        "params": PAR.state_bytes_per_device(params, step.param_specs, mesh),
        "momentum": PAR.state_bytes_per_device(
            tree.map(lambda a: torch.empty(a.shape, dtype=torch.float32,
                                           device="meta"), params),
            step.param_specs, mesh)}}
    p = PAR.shard_tree(mesh, params, step.param_specs)
    del params
    gc.collect()
    if MESH_DEVICE == "cuda":
        torch.cuda.empty_cache()
    o = sgd.init(p)
    res["local_bytes"] = {
        "params": sum(t.numel() * t.element_size() for t in tree.leaves(p)),
        "momentum": sum(t.numel() * t.element_size()
                        for t in tree.leaves(o.momentum))}
    if cfg.moe is not None:
        ffs = [b["ff"] for slot in p["stack"]["body"] for b in slot
               if "router" in b.get("ff", {})]
        res["experts_local"] = ffs[0]["w_gate"].shape[0]
        res["expert_bytes"] = sum(f[k].numel() * f[k].element_size()
                                  for f in ffs
                                  for k in ("w_gate", "w_up", "w_down"))
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=n_rows * TRAIN_T), TRAIN_T)
    batch = shard_batch({"tokens": torch.as_tensor(
        rows, device=MESH_DEVICE).long()}, mesh)
    res["rows"] = n_rows
    real_slots, drops = MOE._slots, []

    def counted_slots(topi, C_):
        slot, keep = real_slots(topi, C_)
        drops.append(((~keep).sum(), keep.numel()))
        return slot, keep

    res.update({k: [] for k in ("losses", "ms", "launches", "calls",
                                "bytes")})
    if MESH_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for i in range(1 + timed_steps):
        reset_all_launches()
        C.reset_stats()
        MOE._slots = counted_slots if i == 0 else real_slots
        mesh_sync()
        t0 = time.perf_counter()
        p, o, m = step(p, o, batch, i)
        mesh_sync()
        MOE._slots = real_slots
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["launches"].append(all_launches())
        res["calls"].append(C.STATS["calls"])
        res["bytes"].append(C.STATS["bytes"])
        res["losses"].append(float(m["loss"]))
    res["drops"] = [(int(d), n) for d, n in drops]
    res["peak_gib"] = rank_peak_gib()
    # one more step, profiled, each collective in it timed alone
    C.reset_stats()
    with C.timed():
        res["profile"] = rank_profile(lambda: step(p, o, batch,
                                                   1 + timed_steps))
    res["collective_ms"], res["staged_bytes"] = (C.STATS["ms"],
                                                 C.STATS["staged_bytes"])
    # the leaves the step keeps whole over "model" hold the same bits on
    # both ranks of a model group (exact: a gather adds only zeros)
    same, checked = True, 0
    for leaf, s in zip(tree.leaves(p), specs):
        if MODEL_AXIS in PAR._spec_axes(s):
            continue
        bits = leaf.detach().contiguous()
        bits = (bits.view(torch.int16) if bits.element_size() == 2
                else bits.view(torch.int32)).to(torch.int32).reshape(1, -1)
        g = C.all_gather(bits, MODEL_AXIS, mesh, 0)
        same = same and bool(torch.equal(g[0], g[1]))
        checked += 1
    res["model_group_identical"], res["checked_leaves"] = same, checked
    res["coords"] = mesh.coords
    rank_dump(out, rank, res)


def mesh_lm_gates(label, ranks, L):
    """Exact launches a step on every rank, the loss falling on each, the
    model-replicated leaves bit-identical across each model group."""
    want = want_launches(rmsnorm_residual=2 * L + 1,
                         rmsnorm_residual_backward=2 * L + 1, swiglu=L,
                         swiglu_backward=L, flash_attention_rope=L,
                         flash_attention_backward=L)
    for r, res in enumerate(ranks):
        if any(l != want for l in res["launches"]):
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{res['launches']}, want {want}")
        losses = res["losses"]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{label} rank {r}: loss did not fall: "
                                 f"{losses}")
        if not res["model_group_identical"]:
            raise AssertionError(f"{label} rank {r}: model-replicated "
                                 f"leaves differ across its model group")
    return want


def mesh_lm_summary(label, ranks, want):
    step_ms = [median(r["ms"][1:]) for r in ranks]
    log(f"{label} (4 ranks on one card, (2 data, 2 model), "
        f"B={ranks[0]['rows']} x T={TRAIN_T} globally): step ms a rank "
        f"{[[round(t, 1) for t in r['ms']] for r in ranks]} (medians "
        f"{[round(t, 1) for t in step_ms]}); losses "
        f"{[[round(x, 4) for x in r['losses']] for r in ranks]}; "
        f"collectives a step {ranks[0]['calls'][1]} calls, "
        f"{ranks[0]['bytes'][1]} bytes, "
        f"{[round(r['collective_ms'], 1) for r in ranks]} ms (staged "
        f"{ranks[0]['staged_bytes']} bytes); peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; state a rank "
        f"{ranks[0]['local_bytes']} bytes (state_bytes_per_device "
        f"{ranks[0]['state_bytes']}); model-replicated leaves checked "
        f"{ranks[0]['checked_leaves']} a rank, bit-identical; launches a "
        f"step { {k: v for k, v in want.items() if v} }")
    for r, res in enumerate(ranks):
        prof = res["profile"]
        log(f"  profile rank {r}: busy {prof['busy_ms']} ms, by family "
            f"{ {k: round(v, 3) for k, v in prof['families'].items()} }, "
            f"kernels {prof['calls']}")
    return {"step_ms": step_ms, "ranks": ranks, "launches": want}


def phase_mesh_lm():
    """Phase 32: qwen3-1.7b at published widths, depth cut to
    MESH_LM_LAYERS, over 4 ranks as (2 data, 2 model), tp=True and
    fsdp=True, bf16, SGD at TRAIN_LR, no noise, B=8 x 512 globally; 1 warm
    and MESH_LM_STEPS timed steps. Gates (``mesh_lm_gates``): a step's
    launches on every rank exactly 17 rmsnorm_residual and its backward, 8
    of swiglu, swiglu_backward, flash_attention_rope and
    flash_attention_backward (a rank's TP slice, 8 of 16 q heads, 4 of 8
    kv heads and d_ff 3072, through the same kernels), nothing else; the
    loss falls; the model-replicated leaves are bit-identical across each
    model group."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn_ranks("phase 32", lm_mesh_rank, 4, "tp_fsdp")
    want = mesh_lm_gates("phase 32", ranks, MESH_LM_LAYERS)
    return mesh_lm_summary(f"phase 32 {SERVE_ARCH} tp+fsdp "
                           f"({MESH_LM_LAYERS} of 28 layers)", ranks, want)


def phase_mesh_ep():
    """Phase 33: qwen2-moe-a2.7b at published widths, depth cut to
    MESH_EP_LAYERS, over 4 ranks as (2 data, 2 model): 30 of the 60
    experts a rank, the large leaves also FSDP over "data"
    (MESH_LM_KINDS says why); bf16, B=MESH_EP_B x 512 globally,
    1 warm and MESH_EP_STEPS timed steps. Gates: ``mesh_lm_gates`` (5/5
    norm, 2/2 SwiGLU (the shared expert), 2/2 RoPE flash attention a
    step); 30 local experts; the dropped assignments of the first step's
    first MoE layer equal, in count, the single-process card forward's on
    the same global batch and parameters (its inputs are the same rows
    through the same replicated layers); a later layer's share within
    DROP_TOL of it (its input carries the experts' combine, summed over
    the model group in another order)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_sequences, token_lm
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              body_repeats=MESH_EP_LAYERS)
    params = TT.init_params(SERVE_SEED, cfg, MESH_DEVICE)
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=MESH_EP_B * TRAIN_T), TRAIN_T)
    tokens = torch.as_tensor(rows, device=MESH_DEVICE).long()
    real_slots, drops = MOE._slots, []

    def counted_slots(topi, C_):
        slot, keep = real_slots(topi, C_)
        drops.append(((~keep).sum(), keep.numel()))
        return slot, keep

    MOE._slots = counted_slots
    try:
        with torch.no_grad():
            TT.lm_loss(params, cfg, {"tokens": tokens}, use_kernels=True)
    finally:
        MOE._slots = real_slots
    want_drops = [(int(d), n) for d, n in drops]
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn_ranks("phase 33", lm_mesh_rank, 4, "ep")
    want = mesh_lm_gates("phase 33", ranks, MESH_EP_LAYERS)
    if any(r["experts_local"] != cfg.moe.n_experts // 2 for r in ranks):
        raise AssertionError("phase 33: a rank does not hold 30 experts")
    # model rank 0 of each data row: its tokens' routing (the model group
    # routes the same tokens)
    rows_of = [r for r in ranks if r["coords"]["model"] == 0]
    got = [(sum(r["drops"][l][0] for r in rows_of),
            sum(r["drops"][l][1] for r in rows_of))
           for l in range(len(want_drops))]
    shares = [(g[0] / g[1], w[0] / w[1]) for g, w in zip(got, want_drops)]
    log(f"phase 33 dropped assignments by layer (mesh, one process): "
        f"{got} vs {want_drops}; shares "
        f"{[(round(a, 5), round(b, 5)) for a, b in shares]}")
    if got[0] != want_drops[0]:
        raise AssertionError(f"phase 33: first MoE layer drops {got[0]}, "
                             f"one process {want_drops[0]}")
    if any(abs(a - b) > DROP_TOL for a, b in shares[1:]):
        raise AssertionError(f"phase 33: dropped shares {shares}")
    out = mesh_lm_summary(f"phase 33 {MOE_ARCH} ep+fsdp ({MESH_EP_LAYERS} of 24 "
                          f"layers, {ranks[0]['experts_local']} of "
                          f"{cfg.moe.n_experts} experts a rank, "
                          f"{ranks[0]['expert_bytes']} expert bytes a rank)",
                          ranks, want)
    out["shares"] = shares
    return out


def parity_setup(key):
    """A reduced config in f32 and its parameters and tokens (the same in
    every process: CPU generators, then moved)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_config(MESH_PARITY_ARCHS[key]),
                              dtype="float32")
    params = tree.map(lambda t: t.to(MESH_DEVICE),
                      TT.init_params(3, cfg, device="cpu"))
    g = torch.Generator().manual_seed(6)
    tokens = [torch.randint(0, cfg.vocab_size, (8, 64), generator=g)
              .to(MESH_DEVICE) for _ in range(MESH_PARITY_STEPS)]
    return cfg, params, tokens


def parity_recipe(optimizer):
    from repro_torch.core import LargeBatchConfig, Regime
    lb = LargeBatchConfig(batch_size=8, base_batch_size=8, grad_clip=1.0)
    return lb, Regime(base_lr=MESH_PARITY_LR[optimizer], total_steps=10,
                      drop_every=10)


def parity_rank(rank, out, ckpt_dir):
    """Phase 34's 4 ranks: every mode of MESH_PARITY_MODES for
    MESH_PARITY_STEPS steps (kernels on); the tp_fsdp_sgd run writes its
    sharded checkpoint. Rank 0 keeps each run's whole parameters."""
    rank_setup()
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_2d_mesh, make_data_mesh
    from repro_torch.optim import adam, sgd
    from repro_torch.train import parallel as PAR
    from repro_torch.train.trainer import make_lm_train_step
    meshes = {"data": make_data_mesh(device=MESH_DEVICE),
              "2d": make_2d_mesh(device=MESH_DEVICE)}
    res = {}
    for name, (key, mkey, tp, fsdp, opt_name) in MESH_PARITY_MODES.items():
        mesh = meshes[mkey]
        cfg, params, tokens = parity_setup(key)
        lb, regime = parity_recipe(opt_name)
        step = make_lm_train_step(cfg, lb, regime, use_kernels=True,
                                  mesh=mesh, params=params, tp=tp,
                                  fsdp=fsdp, optimizer=opt_name)
        init = adam.init if opt_name == "adam" else sgd.init
        p = PAR.shard_tree(mesh, params, step.param_specs)
        o = PAR.shard_tree(mesh, init(params), step.opt_specs)
        losses = []
        for i, t in enumerate(tokens):
            p, o, m = step(p, o, shard_batch({"tokens": t}, mesh), i)
            losses.append(float(m["loss"]))
        whole = flat_leaves(PAR.unshard_tree(mesh, p, step.param_specs))
        res[name] = {"losses": losses,
                     "params": whole.cpu().numpy() if rank == 0 else None}
        if name == "tp_fsdp_sgd":
            ckpt.save(ckpt_dir, MESH_PARITY_STEPS, p, o, sharded=True,
                      layout=(mesh, step.param_specs, step.opt_specs))
    rank_dump(out, rank, res)


def sweep_rank(rank, out, sweep_dir):
    """Phase 34's 2-rank sweep: MESH_SWEEP with use_mesh=True."""
    rank_setup()
    from repro_torch.experiments import registry
    from repro_torch.experiments.runner import run_sweep
    sweep = registry.generalization_gap(**MESH_SWEEP, use_mesh=True)
    rank_dump(out, rank, run_sweep(sweep, sweep_dir, device=MESH_DEVICE))


def phase_mesh_parity(tmp):
    """Phase 34: reduced f32, card against card, within TOL (losses
    LOSS_TOL): each mode of MESH_PARITY_MODES over 4 ranks (dp over (4,),
    tp, fsdp and tp+fsdp over (2, 2), SGD and Adam; EP on reduced
    qwen2-moe) against the single-process card step on the same global
    batches; int8 momentum, one process, card against CPU; a 2-step
    generalization-gap sweep with use_mesh=True over 2 ranks against the
    single-process sweep (the +GBN columns' distance series within TOL,
    accuracies, read through the running statistics whose EMA each rank
    folds on its own, within ACC_TOL; the plain-BN columns, which
    normalize over a rank's shard by design, run their steps); and the
    tp_fsdp_sgd run's sharded checkpoint, written by the 4 ranks,
    restored in one process equal to its whole parameters bit for bit."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.experiments import registry
    from repro_torch.experiments.runner import run_sweep
    from repro_torch.optim import adam, sgd
    from repro_torch.train.trainer import make_lm_train_step
    want = {}
    for key, opt_name in {(v[0], v[4]) for v in MESH_PARITY_MODES.values()}:
        cfg, params, tokens = parity_setup(key)
        lb, regime = parity_recipe(opt_name)
        step = make_lm_train_step(cfg, lb, regime, use_kernels=True,
                                  optimizer=opt_name)
        p = params
        o = (adam.init if opt_name == "adam" else sgd.init)(p)
        losses = []
        for i, t in enumerate(tokens):
            p, o, m = step(p, o, {"tokens": t}, i)
            losses.append(float(m["loss"]))
        want[(key, opt_name)] = (losses, flat_leaves(p).cpu())
    ckpt_dir = str(Path(tmp) / "sharded_ckpt")
    ranks = spawn_ranks("phase 34 modes", parity_rank, 4, ckpt_dir)
    worst = {}
    for name, (key, _, _, _, opt_name) in MESH_PARITY_MODES.items():
        losses, params = want[(key, opt_name)]
        for r, res in enumerate(ranks):
            check_close(f"{name} r{r} losses",
                        torch.tensor(res[name]["losses"]),
                        torch.tensor(losses), LOSS_TOL)
        worst[name] = check_close(f"{name} params",
                                  torch.as_tensor(ranks[0][name]["params"]),
                                  params, TOL)
    # int8 momentum, one process: card (kernels) against CPU (plain)
    outs = {}
    for dev in (MESH_DEVICE, "cpu"):
        cfg, params, tokens = parity_setup("dense")
        lb, regime = parity_recipe("sgd")
        step = make_lm_train_step(cfg, lb, regime, use_kernels=dev != "cpu",
                                  momentum_dtype="int8")
        p = tree.map(lambda t: t.to(dev), params)
        o = sgd.init(p, momentum_dtype="int8")
        losses = []
        for i, t in enumerate(tokens):
            p, o, m = step(p, o, {"tokens": t.to(dev)}, i)
            losses.append(float(m["loss"]))
        outs[dev] = (losses, flat_leaves(p).cpu())
    check_close("int8 momentum losses", torch.tensor(outs[MESH_DEVICE][0]),
                torch.tensor(outs["cpu"][0]), LOSS_TOL)
    worst["int8"] = check_close("int8 momentum params", outs[MESH_DEVICE][1],
                                outs["cpu"][1], TOL)
    # the sharded checkpoint, restored in one process
    cfg, params, _ = parity_setup("dense")
    got, step_no = ckpt.restore(ckpt_dir, params)
    meta = ckpt.load_meta(ckpt_dir)
    shards = sorted(p.name for p in Path(ckpt_dir).glob("params_*.shard*"))
    if step_no != MESH_PARITY_STEPS or meta["num_processes"] != 4 or \
            len(shards) != 4 or not torch.equal(
                flat_leaves(got).cpu(),
                torch.as_tensor(ranks[0]["tp_fsdp_sgd"]["params"])):
        raise AssertionError(f"sharded checkpoint: step {step_no}, meta "
                             f"{meta}, shards {shards}")
    log(f"  sharded checkpoint: {shards} + meta (num_processes 4), "
        f"restored in one process bit-equal to the ranks' parameters")
    # the use_mesh sweep over 2 ranks against one process
    solo = run_sweep(registry.generalization_gap(**MESH_SWEEP),
                     str(Path(tmp) / "solo_sweep"), device=MESH_DEVICE)
    by_method = {r["method"]: r for r in solo}
    swept = spawn_ranks("phase 34 sweep", sweep_rank, 2,
                        str(Path(tmp) / "mesh_sweep"))
    for recs in swept:
        if sorted(r["method"] for r in recs) != sorted(by_method):
            raise AssertionError("use_mesh sweep: methods differ")
        for r in recs:
            w = by_method[r["method"]]
            if r["steps"] != w["steps"] or not all(
                    math.isfinite(r[k]) for k in ("final_acc", "train_acc")):
                raise AssertionError(f"use_mesh sweep {r['method']}: bad "
                                     f"record")
            if not r["spec"]["lb"]["use_gbn"]:
                continue
            for k in ("final_acc", "best_acc", "train_acc"):
                if abs(r[k] - w[k]) > ACC_TOL:
                    raise AssertionError(f"use_mesh sweep {r['method']} {k}"
                                         f": {r[k]} vs {w[k]}")
            check_close(f"sweep {r['method']} distance",
                        torch.tensor(r["metrics"]["distance"][1]),
                        torch.tensor(w["metrics"]["distance"][1]), TOL)
    log(f"phase 34 parity (reduced f32, card against card, 4 ranks): worst "
        f"parameter error by mode { {k: float(f'{v:.3e}') for k, v in worst.items()} }"
        f"; use_mesh sweep over 2 ranks: " + ", ".join(
            f"{r['method']} acc {r['final_acc']:.4f} (one process "
            f"{by_method[r['method']]['final_acc']:.4f})" for r in swept[0]))
    return worst


def mesh_kernel_line(dp, lm, ep):
    """Slice 9's kernels: launches a step on a rank and device ms a step in
    each rank's profiled step, per phase (ranks share the card, so these
    are not scaling numbers)."""
    rows = []
    for label, run in (("phase 31", dp), ("phase 32", lm), ("phase 33", ep)):
        profs = run["profile"] if label == "phase 31" else \
            [r["profile"] for r in run["ranks"]]
        launches = run["launches"]
        for name in MESH_KERNELS:
            n = launches.get(name, 0)
            if not n:
                continue
            fam = MESH_FAMILIES[name]
            rows.append({"phase": label, "name": name, "launches": n,
                         "ms_by_rank": [round(p["families"].get(fam, 0.0), 4)
                                        for p in profs],
                         "family": fam})
    log("slice 9 mesh kernels: " + json.dumps(rows))
    return rows


# ---------------------------------------------------------------------------
# slice 10: model-sharded serving and the launchers
# ---------------------------------------------------------------------------

SHARDED_KERNELS = ("rmsnorm_residual", "swiglu", "flash_attention",
                   "flash_decode_paged")
# reduced qwen3 in f32 over the same ranks: a trace that reuses slots
SHARDED_F32 = dict(trace=dict(n_requests=12, rate=0.5,
                              prompt_len_choices=(8, 16, 24),
                              new_token_choices=(4, 8, 16), seed=1),
                   engine=dict(num_slots=4, max_len=48, layout="paged",
                               page_size=16))


SHARDED_STEADY = (8, 8)   # phase 35: steps timed, then steps with each
                          # collective timed alone, 16 rows active


def steady_steps(eng, trace):
    """Decode steps of ``eng`` with its 16 slots busy (the first
    ENGINE_SLOTS requests, all arriving at once): after 8 warm steps,
    SHARDED_STEADY[0] steps each timed by the host clock around a
    synchronized step, SHARDED_STEADY[1] steps with each collective timed
    alone, then one step profiled (``rank_profile``: device busy ms); the
    run stops there. Every rank takes the same steps."""
    from repro_torch.launch import collectives as C
    step, n_ms, n_coll = eng.step, *SHARDED_STEADY
    rec = {"step_ms": [], "collective_ms": 0.0, "collective_calls": 0}

    def measured():
        i = eng.steps - 8
        if i < 0:
            step()
        elif i < n_ms:
            mesh_sync()
            t0 = time.perf_counter()
            step()
            mesh_sync()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        elif i < n_ms + n_coll:
            C.reset_stats()
            with C.timed():
                step()
            rec["collective_ms"] += C.STATS["ms"] / n_coll
            rec["collective_calls"] = C.STATS["calls"]
        else:
            rec["profile"] = rank_profile(step)
            raise _Stop

    eng.step = measured
    try:
        eng.run([dataclasses.replace(r, arrival=0.0)
                 for r in trace[:ENGINE_SLOTS]])
    except _Stop:
        pass
    finally:
        eng.step = step
    if "profile" not in rec:
        raise AssertionError(f"steady steps: the run ended after "
                             f"{eng.steps} steps, before its profiled one")
    return rec


def sharded_engine_rank(rank, out):
    """Phase 35's rank: phase 10's model and trace through
    ContinuousEngine(mesh=) on (1 data, 2 model), a bf16 then an int8
    pool (each run's launches, collectives, decode step times and
    admissions' prefill logits), then steady decode steps of the bf16
    pool (``steady_steps``); then reduced f32 sharded against the
    unsharded engine on this rank."""
    import torch
    rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import make_2d_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.serving import ContinuousEngine, poisson_trace
    mesh = make_2d_mesh(model=2, device=MESH_DEVICE)
    cfg, params = engine_model(serve_params())
    trace = poisson_trace(cfg, **ENGINE_TRACE)
    kw = dict(num_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
              layout="paged", page_size=ENGINE_PAGE)
    res = {"coords": mesh.coords}
    engines = {}
    for cache_dtype in (None, "int8"):
        label = cache_dtype or "bf16"
        eng = ContinuousEngine(params, cfg, mesh=mesh,
                               cache_dtype=cache_dtype, **kw)
        engines[label] = eng
        step, step_s = eng.step, []

        def timed_step(step=step, step_s=step_s):
            t0 = time.perf_counter()
            step()
            step_s.append(time.perf_counter() - t0)

        admit, order = eng._admit, []

        def ordered_admit(req, slot, admit=admit, order=order):
            ok = admit(req, slot)
            if ok:
                order.append(req.id)
            return ok

        eng.step, eng._admit = timed_step, ordered_admit
        mesh_sync()
        reset_serving_launches()
        C.reset_stats()
        t0 = time.perf_counter()
        with admission_logits() as logits:
            comps = eng.run(trace)
        mesh_sync()
        wall = time.perf_counter() - t0
        eng.step, eng._admit = step, admit
        res[label] = {
            "wall_s": wall, "stats": eng.stats(),
            "launches": {k: serving_launches()[k] for k in SHARDED_KERNELS},
            "collectives": {k: C.STATS[k] for k in ("calls", "bytes",
                                                    "staged_bytes")},
            "step_ms": sum(step_s) * 1e3 / len(step_s),
            "tokens": {i: c.tokens for i, c in comps.items()},
            "logits": [lg.float().cpu().numpy() for lg in logits],
            "order": order,
            "pool_bytes": pool_bytes(eng.cache),
            "pool_shape": tuple(eng.cache["body"][0][0]["attn"]["kp"].shape),
            "peak_gib": rank_peak_gib()}
    del params
    gc.collect()
    res["bf16"]["steady"] = steady_steps(engines["bf16"], trace)
    del engines
    gc.collect()
    if MESH_DEVICE == "cuda":
        torch.cuda.empty_cache()
    rcfg = dataclasses.replace(get_config(SERVE_ARCH + "-reduced"),
                               dtype="float32")
    rparams = TT.init_params(SERVE_SEED, rcfg, MESH_DEVICE)
    rtrace = poisson_trace(rcfg, **SHARDED_F32["trace"])
    solo = ContinuousEngine(rparams, rcfg, device=MESH_DEVICE,
                            **SHARDED_F32["engine"]).run(rtrace)
    sharded = ContinuousEngine(rparams, rcfg, mesh=mesh,
                               **SHARDED_F32["engine"]).run(rtrace)
    res["f32"] = {"solo": {i: c.tokens for i, c in solo.items()},
                  "sharded": {i: c.tokens for i, c in sharded.items()}}
    rank_dump(out, rank, res)


def phase_sharded_engine(engine):
    """Phase 35 (see the module doc): the gates against phase 10's runs
    (``engine``, phase_engine's result) and the printed numbers."""
    import numpy as np
    ranks = spawn_ranks("phase 35", sharded_engine_rank, 2)
    by_id = engine["prefill_logits"]
    order = [i for i, *_ in engine["admits"]]
    L = ENGINE_LAYERS
    out = {"ranks": ranks}
    ties = []
    for r, res in enumerate(ranks):
        for label in ("bf16", "int8"):
            run, want = res[label], engine[label]["launches"]
            got = run["launches"]
            if any(got[k] != want[k] for k in SHARDED_KERNELS):
                raise AssertionError(
                    f"phase 35 rank {r} {label}: launches {got}, phase "
                    f"10's { {k: want[k] for k in SHARDED_KERNELS} }")
            if run["order"] != order:
                raise AssertionError(f"phase 35 rank {r} {label}: "
                                     f"admissions {run['order']}, phase "
                                     f"10's {order}")
            worst = 0.0
            for i, lg in zip(order, run["logits"]):
                ref = by_id[i]
                err = float(np.abs(lg - ref).max() / np.abs(ref).max())
                worst = max(worst, err)
                if err > BF16_TOL:
                    raise AssertionError(
                        f"phase 35 rank {r} {label}: request {i}'s prefill "
                        f"logits {err:.4g} of their largest magnitude "
                        f"from phase 10's (> {BF16_TOL})")
                first, ref_first = run["tokens"][i][0], \
                    engine["tokens"][label][i][0]
                if first == ref_first:
                    continue
                # a near-tie of phase 10's own logits: its pick leads ours
                # by less than the logits' tolerance
                margin = float((ref[ref_first] - ref[first])
                               / np.abs(ref).max())
                ties.append((r, label, i, first, ref_first, margin))
                if margin > BF16_TOL:
                    raise AssertionError(
                        f"phase 35 rank {r} {label}: request {i}'s first "
                        f"token {first}, phase 10's {ref_first}, whose "
                        f"logit leads by {margin:.4g} of the largest "
                        f"magnitude (> {BF16_TOL})")
            ref_toks = engine["tokens"][label]
            same = sum(a == b for i in ref_toks
                       for a, b in zip(ref_toks[i], run["tokens"][i]))
            total = sum(len(t) for t in ref_toks.values())
            run["agreement"] = same / total
            run["worst_logits"] = worst
        if res["f32"]["sharded"] != res["f32"]["solo"]:
            bad = [i for i in res["f32"]["solo"]
                   if res["f32"]["sharded"].get(i) != res["f32"]["solo"][i]]
            raise AssertionError(f"phase 35 rank {r}: reduced f32 sharded "
                                 f"tokens differ from the unsharded "
                                 f"engine's for requests {bad}")
    for label in ("bf16", "int8"):
        runs = [res[label] for res in ranks]
        st = runs[0]["stats"]
        c = runs[0]["collectives"]
        steps = st["steps"]
        log(f"phase 35 {SERVE_ARCH} ({L} of 28 layers) sharded over 2 ranks "
            f"(1 data, 2 model) on one card, {label} pool: tokens equal to "
            f"phase 10's {[round(x['agreement'], 4) for x in runs]} a rank "
            f"(prefill logits within "
            f"{[round(x['worst_logits'], 5) for x in runs]} of their "
            f"largest magnitude); useful tokens/s "
            f"{[round(x['stats']['useful_tok_s'], 1) for x in runs]} "
            f"(phase 10 {engine[label]['stats']['useful_tok_s']:.1f}); "
            f"decode ms a step {[round(x['step_ms'], 3) for x in runs]} "
            f"over {steps:.0f} steps; collectives a run {c['calls']} calls, "
            f"{c['bytes']} bytes ({c['calls'] / steps:.1f} calls, "
            f"{c['bytes'] / steps:.0f} bytes a step, admissions included; "
            f"staged {c['staged_bytes']} bytes); pool bytes a rank "
            f"{runs[0]['pool_bytes']} (phase 10 "
            f"{engine[label]['pool_bytes']}), pool "
            f"{runs[0]['pool_shape']}; peak "
            f"{[round(x['peak_gib'], 2) for x in runs]} GiB; launches a "
            f"rank {runs[0]['launches']}")
    log(f"  phase 35 first tokens: {2 * 2 * len(order) - len(ties)} of "
        f"{2 * 2 * len(order)} (2 ranks x 2 pools x {len(order)} requests) "
        f"equal to phase 10's; the others near-ties of phase 10's logits "
        f"(rank, pool, request, token, phase 10's, its lead over ours "
        f"relative to the largest magnitude): {ties}")
    for r, res in enumerate(ranks):
        st = res["bf16"]["steady"]
        prof = st["profile"]
        step_ms = median(st["step_ms"])
        log(f"  phase 35 rank {r} bf16, 16 active rows: decode step "
            f"{step_ms:.3f} ms (median of {[round(t, 3) for t in st['step_ms']]}"
            f", synchronized); collectives {st['collective_calls']} calls, "
            f"{st['collective_ms']:.3f} ms a step, each timed alone; one "
            f"profiled step busy {prof['busy_ms']:.3f} ms (idle share "
            f"{1 - prof['busy_ms'] / step_ms:.3f}); device ms by family "
            f"{ {k: round(v, 3) for k, v in sorted(prof['families'].items())} }"
            f", kernels {prof['calls']}")
    f32 = ranks[0]["f32"]
    log(f"  phase 35 reduced f32 ({SHARDED_F32}): "
        f"{sum(len(t) for t in f32['solo'].values())} tokens of "
        f"{len(f32['solo'])} requests equal to the unsharded engine's on "
        f"both ranks")
    return out


def trace_spans(events, kernel_fams):
    """Kernels of ``kernel_fams`` in a Chrome trace of ``torch.profiler``:
    {family: {innermost enclosing serve.* span name or None: count}}. A
    kernel is under a span when its device interval lies in one of the
    span's device annotations, or its launch (by correlation id) or its
    start lies in the span's host interval; of those, the shortest is the
    innermost."""
    def within(ev, spans):
        t0, t1 = ev["ts"], ev["ts"] + ev.get("dur", 0)
        return [(s1 - s0, name) for name, s0, s1 in spans
                if s0 <= t0 and t1 <= s1]

    def spans_of(cat):
        return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
                for e in events if e.get("cat") == cat
                and str(e.get("name", "")).startswith("serve.")]

    gpu_spans, cpu_spans = spans_of("gpu_user_annotation"), \
        spans_of("user_annotation")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    out = {f: {} for f in kernel_fams}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        fam = family(e["name"])
        if fam not in out:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        found = within(e, gpu_spans) + within({"ts": e["ts"]}, cpu_spans) \
            + (within(launch, cpu_spans) if launch is not None else [])
        name = min(found)[1] if found else None
        out[fam][name] = out[fam].get(name, 0) + 1
    return out


def phase_launchers(tmp):
    """Phase 36: the launchers as a user runs them, in their own
    processes (the kernels already built in this checkout)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tmp)
    dt_dir = tmp / "device_trace"
    serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 SERVE_ARCH + "-reduced", "--use-kernels", "--continuous",
                 "--device-trace", str(dt_dir), "--trace",
                 str(tmp / "spans.json"), "--metrics-out",
                 str(tmp / "metrics.jsonl")]
    train_cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 SERVE_ARCH + "-reduced", "--steps", "5", "--batch", "8",
                 "--base-batch", "8", "--seq-len", "64", "--log-every", "1",
                 "--ckpt", str(tmp / "ckpt")]
    walls = {}
    for label, cmd in (("serve", serve_cmd), ("train", train_cmd)):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300, cwd=str(tmp))
        walls[label] = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        log(f"phase 36 {' '.join(cmd[1:4])} ... exited {p.returncode} in "
            f"{walls[label]:.1f} s: " + " | ".join(
                line for line in lines
                if line.startswith(("continuous", "static", "step", "done",
                                    "checkpoint", "wrote"))))
        if p.returncode != 0:
            raise AssertionError(f"phase 36 {label}: exit {p.returncode}\n"
                                 f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    traces = sorted(dt_dir.glob("device_trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"phase 36: device traces {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    under = trace_spans(events, ("flash_fwd", "flash_decode_paged"))
    log(f"  phase 36 device trace ({traces[0].stat().st_size} bytes): "
        f"kernels by enclosing span {under}")
    # B9 also runs in the lockstep baseline's prefills, outside any span
    b9, b13 = under["flash_fwd"], under["flash_decode_paged"]
    if {k for k in b9 if k} != {"serve.admit"} \
            or set(b13) != {"serve.decode_step"}:
        raise AssertionError(f"phase 36: B9 kernels {b9}, B13 kernels {b13}"
                             f": want every B9 of the engine under "
                             f"serve.admit and every B13 under "
                             f"serve.decode_step")
    return {"walls": walls, "under": under}


# slice 11: h2o-danube-3-4b at its published widths (head width 120)
H2O_ARCH = "h2o-danube-3-4b"
H2O_KERNELS = {
    # name: (TPU kernel it replaces, the profiled run and family that give
    # its device ms on h2o's path)
    "flash_attention": ("src/repro/kernels/flash_attention.py:187",
                        "generate", "flash_fwd"),
    "flash_decode": ("src/repro/kernels/flash_decode.py:157", "generate",
                     "flash_decode"),
    "flash_decode_paged": ("src/repro/kernels/flash_decode.py:360", None,
                           None),
    "flash_attention_rope": ("src/repro/kernels/flash_attention.py:278",
                             "train", "flash_fwd"),
    "flash_attention_backward": ("src/repro/kernels/flash_attention.py:509",
                                 "train", "flash_bwd"),
}


def h2o_kernel_checks(cfg):
    """B7, B8, B9, B12 and B13 at h2o-danube-3-4b's width 120, on the shapes
    of this phase's runs in bf16: each against its plain version
    (BF16_TOL), and its ms a call by CUDA events around calls queued
    behind a sleep (``queued_ms``: the profiler, late in a run, lost some
    windows' kernels here; inputs from device memory, ``input_copies``)
    beside the plain version's, SDPA's (B13: the page
    gather + SDPA) and the bound. Returns {name: {"err", "row"}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ref
    H, KV, hd, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    theta = cfg.rope_theta
    B, P, n = SERVE_B, SERVE_P, SERVE_NEW
    gen = torch.Generator(device="cuda").manual_seed(120)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    out = {}

    def check(name, label, got, want):
        errs = [check_close(f"{name} {label}", a.float(), b.float(), BF16_TOL)
                for a, b in zip(got, want)]
        out.setdefault(name, {"err": 0.0})
        out[name]["err"] = max([out[name]["err"]] + errs)

    # B9: the ragged prefill of generate (window W, left pads)
    q, k, v = randn(B, H, P, hd), randn(B, KV, P, hd), randn(B, KV, P, hd)
    off = serve_offsets(PROMPT_LENS, P)
    check("flash_attention", f"B={B} H={H} KV={KV} T={P} hd={hd} window {W}"
          f" ragged", [FA.flash_attention_fwd(q, k, v, window=W,
                                              kv_offsets=off)],
          [ref.attention_ref(q, k, v, window=W, kv_offsets=off)])
    keys = torch.arange(P, device="cuda")
    mask = ((keys[None, :] <= keys[:, None])[None]
            & (keys[None, None, :] >= off[:, None, None].long()))[:, None]
    ins = input_copies(q, k, v)
    out["flash_attention"]["row"] = time_row(
        "flash_attention", f"h2o {P}",
        rotating(lambda a, b, c: FA.flash_attention_fwd(
            a, b, c, window=W, kv_offsets=off), ins),
        rotating(lambda a, b, c: ref.attention_ref(
            a, b, c, window=W, kv_offsets=off), ins),
        rotating(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, enable_gqa=True), ins),
        attn_work(B, H, KV, P, hd, PROMPT_LENS), timer=queued_ms)
    del ins

    # B7 and B8: the train step's attention (causal, window W, RoPE)
    T = TRAIN_T
    pos = torch.arange(T, device="cuda", dtype=torch.float32)[None].expand(
        TRAIN_B, T).contiguous()
    q, k, v, do = (randn(TRAIN_B, h, T, hd) for h in (H, KV, KV, H))
    o, lse = FA.flash_attention_rope_fwd(q, k, v, pos, theta=theta,
                                         window=W, return_lse=True)
    wo, wl = ref.attention_rope_ref(q, k, v, pos, theta=theta, window=W,
                                    return_lse=True)
    check("flash_attention_rope", f"B={TRAIN_B} H={H} KV={KV} T={T} hd={hd}"
          f" window {W}", [o, lse], [wo, wl])
    qr, kr = ref.rope_rotate_hm(q, pos, theta), ref.rope_rotate_hm(k, pos,
                                                                   theta)
    got = FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                           theta=theta, window=W)
    dq, dk, dv = ref.attention_backward_ref(qr, kr, v, o, lse, do, window=W)
    want = (ref.rope_rotate_hm(dq, -pos, theta),
            ref.rope_rotate_hm(dk, -pos, theta), dv)
    check("flash_attention_backward", f"B={TRAIN_B} H={H} KV={KV} T={T} "
          f"hd={hd} window {W} RoPE dq, dk, dv", got, want)
    ins = input_copies(q, k, v)
    out["flash_attention_rope"]["row"] = time_row(
        "flash_attention_rope", f"h2o {T}",
        rotating(lambda a, b, c: FA.flash_attention_rope_fwd(
            a, b, c, pos, theta=theta, window=W, return_lse=True), ins),
        rotating(lambda a, b, c: ref.attention_rope_ref(
            a, b, c, pos, theta=theta, window=W, return_lse=True), ins),
        rotating(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), ins),
        attn_rope_work(TRAIN_B, H, KV, T, hd), timer=queued_ms)
    del ins
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (qr, kr, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                        enable_gqa=True)
    out["flash_attention_backward"]["row"] = time_row(
        "flash_attention_backward", f"h2o {T}",
        lambda: FA.flash_attention_rope_backward(q, k, v, pos, o, lse, do,
                                                 theta=theta, window=W),
        lambda: ref.attention_backward_ref(qr, kr, v, o, lse, do, window=W),
        lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
        attn_bwd_work(TRAIN_B, H, KV, T, hd), timer=queued_ms)
    del ql, kl, vl, ol, q, k, v, do, o, lse, qr, kr

    # B12: the last decode step of generate (every layer slides: a ring of
    # min(P + n, W) slots)
    S = min(P + n, W)
    last = P + n - 2
    q, k, v = randn(B, H, hd), randn(B, KV, S, hd), randn(B, KV, S, hd)
    kw = dict(window=W, ring=True, offsets=off, rope_theta=theta)
    check("flash_decode", f"B={B} H={H} KV={KV} S={S} hd={hd} pos {last} "
          f"ring window {W}", [FD.flash_decode(q, k, v, last, **kw)],
          [ref.flash_decode_ref(q, k, v, last, **kw)])
    slots = torch.arange(S, device="cuda")
    dmask = ((slots[None, :] <= last)
             & (slots[None, :] >= off[:, None].long()))[:, None, None]
    qr = ref.rope_rotate(q, (last - off.long())[:, None].expand(B, H),
                         theta).bfloat16()[:, :, None]
    ins = input_copies(k, v)
    out["flash_decode"]["row"] = time_row(
        "flash_decode", f"h2o pos {last}",
        rotating(lambda a, b: FD.flash_decode(q, a, b, last, **kw), ins),
        rotating(lambda a, b: ref.flash_decode_ref(q, a, b, last, **kw),
                 ins),
        rotating(lambda a, b: F.scaled_dot_product_attention(
            qr, a, b, attn_mask=dmask, enable_gqa=True), ins),
        decode_work(B, H, KV, hd, [last - int(o) + 1 for o in off]),
        timer=queued_ms)
    del ins, q, k, v

    # B13: a full page pool of the engine's shape at width 120, bf16 and
    # int8 (h2o's own engine keeps every layer's ring and runs B12: all of
    # its layers slide)
    Be, Se, ps = ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_PAGE
    q = randn(Be, H, hd)
    k, v = randn(Be, KV, Se, hd), randn(Be, KV, Se, hd)
    kp, vp, pt = paged_from_contiguous(k, v, ps, seed=120)
    (kq, ks), (vq, vs) = ref.quantize_slots(kp), ref.quantize_slots(vp)
    del k, v
    pe = torch.arange(Be, device="cuda", dtype=torch.int32) * 56 + 128
    offe = (torch.arange(Be, device="cuda", dtype=torch.int32) * 7) % 64
    label = f"B={Be} H={H} KV={KV} pages {kp.shape[0]}x{ps} hd={hd}"
    kw = dict(offsets=offe, rope_theta=theta)
    check("flash_decode_paged", f"{label} bf16 pool",
          [FD.flash_decode_paged(q, kp, vp, pt, pe, **kw)],
          [ref.flash_decode_paged_ref(q, kp, vp, pt, pe, **kw)])
    sc = dict(k_scale=ks, v_scale=vs, **kw)
    check("flash_decode_paged", f"{label} int8 pool",
          [FD.flash_decode_paged(q, kq, vq, pt, pe, **sc)],
          [ref.flash_decode_paged_ref(q, kq, vq, pt, pe, **sc)])
    qr = ref.rope_rotate(q, (pe - offe).long()[:, None].expand(Be, H),
                         theta).bfloat16()[:, :, None]
    pmask = ((torch.arange(Se, device="cuda")[None, :] <= pe[:, None].long())
             & (torch.arange(Se, device="cuda")[None, :]
                >= offe[:, None].long()))[:, None, None]

    def gather_sdpa(kp_, vp_):
        rows = pt.long()
        kg = kp_[rows].transpose(1, 2).reshape(Be, KV, Se, hd)
        vg = vp_[rows].transpose(1, 2).reshape(Be, KV, Se, hd)
        return F.scaled_dot_product_attention(qr, kg, vg, attn_mask=pmask,
                                              enable_gqa=True)

    vis = [int(p) - int(o) + 1 for p, o in zip(pe, offe)]
    for pool, fn, plain, esize in (
            ("bf16", lambda a, b, *_: FD.flash_decode_paged(
                q, a, b, pt, pe, **kw),
             lambda a, b, *_: ref.flash_decode_paged_ref(
                 q, a, b, pt, pe, **kw), 2),
            ("int8", lambda a, b, c, d: FD.flash_decode_paged(
                q, a, b, pt, pe, k_scale=c, v_scale=d, **kw),
             lambda a, b, c, d: ref.flash_decode_paged_ref(
                 q, a, b, pt, pe, k_scale=c, v_scale=d, **kw), 1)):
        ins = input_copies(*((kp, vp) if pool == "bf16" else (kq, vq, ks,
                                                             vs)))
        row = time_row(
            "flash_decode_paged", f"h2o {pool} pool", rotating(fn, ins),
            rotating(plain, ins),
            rotating(lambda a, b, *_: gather_sdpa(a, b),
                     ins if pool == "bf16" else input_copies(kp, vp)),
            paged_work([v_ - 1 for v_ in vis], KV, H, hd, ps, esize,
                       int8=pool == "int8"), timer=queued_ms)
        out["flash_decode_paged"]["row" if pool == "bf16" else "int8_row"] \
            = row
        del ins
    del q, kp, vp, kq, vq, ks, vs
    torch.cuda.empty_cache()
    return out


def phase_h2o():
    """Phase 37: h2o-danube-3-4b at its published widths (d_model 3840, 32
    heads, 8 kv heads, head width 120, d_ff 10240, window 4096; random bf16
    weights from SERVE_SEED) with use_kernels: ``h2o_kernel_checks``, then
    ``generate`` (phase 7's prompts, 32 greedy tokens, all 24 layers; launch
    counts exact; rows 0 and 7 equal to their unpadded runs; prefill and
    decode ms; a profiled generate), ContinuousEngine on phase 10's
    slots, pages and trace (every layer slides, so the engine keeps its
    bf16 rings and decodes through B12, as the reference's engine does;
    launch counts exact; useful tokens/s), and
    ``train_steps`` at B=8 x 512 over all 24 layers: bf16 weights and
    f32 momentum 22 GiB, the step's new state and gradients 30 GiB more,
    activations ~8 GiB (qwen3's phase 13 scaled by width and depth), so
    ~60 GiB at the peak. Returns the measurements."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_sequences, token_lm
    from repro_torch.serving import (ContinuousEngine, generate,
                                     poisson_trace)
    cfg = get_config(H2O_ARCH)
    L, n = cfg.n_layers, SERVE_NEW
    t_phase, secs = time.perf_counter(), {}

    def mark(part):
        secs[part] = round(time.perf_counter() - t_phase
                           - sum(secs.values()), 1)

    out = {"kernels": h2o_kernel_checks(cfg)}
    mark("kernel checks")
    params = model_params(cfg)

    # generate
    prompts = ragged_prompts(cfg.vocab_size, SERVE_SEED + 1)
    kw = dict(max_new_tokens=n, prompt_lens=PROMPT_LENS)
    generate(params, cfg, prompts, **kw)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    want = want_launches(flash_attention=L, flash_decode=L * (n - 1),
                         rmsnorm_residual=(2 * L + 1) * n, swiglu=L * n)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  h2o generate: wall {wall * 1e3:.1f} ms ({SERVE_B * n / wall:.1f}"
        f" new tokens/s), peak {peak:.2f} GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"h2o generate launches {launches}, want {want}")
    if not (bool((toks[:, SERVE_P:] >= 0).all())
            and bool((toks[:, SERVE_P:] < cfg.vocab_size).all())):
        raise AssertionError("h2o generate: ids outside the vocabulary")
    for b in (0, SERVE_B - 1):
        # alone unpadded, B12 hands the row's chunks to other cluster ranks
        # (a rank takes chunks by absolute slot index), which merge them in
        # another order, so its logits may differ by rounding: a token may
        # differ only where the solo run's logits are near-tied (phase 35's
        # rule), and is then logged
        Lb = PROMPT_LENS[b]
        prompt = prompts[b, SERVE_P - Lb:]
        solo = generate(params, cfg, prompt[None], max_new_tokens=n)
        solo, got = solo[0, Lb:].tolist(), toks[b, SERVE_P:].tolist()
        if solo == got:
            log(f"  h2o row {b} (prompt {Lb}) alone unpadded: equal")
            continue
        d = next(i for i, (x, y) in enumerate(zip(solo, got)) if x != y)
        lg = solo_logits(params, cfg, prompt.tolist(), solo, d)
        margin = float((lg[solo[d]] - lg[got[d]]) / lg.abs().max())
        log(f"  h2o row {b} (prompt {Lb}) alone unpadded: first differs at "
            f"generated token {d} ({got[d]} batched, {solo[d]} alone), "
            f"whose logit leads the batched pick by {margin:.4g} of the "
            f"largest magnitude in the solo run")
        if margin > BF16_TOL:
            raise AssertionError(f"h2o row {b} differs from its unpadded run "
                                 f"where its logits are not near-tied")
    from repro_torch.models import transformer as TT
    from repro_torch.serving import make_serve_step, prefill_fused
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
    del cache
    out["generate"] = {
        "wall_ms": wall * 1e3, "prefill_ms": sorted(pre)[1],
        "decode_ms": start.elapsed_time(end) / (n - 1), "peak_gib": peak,
        "launches": launches,
        "profile": family_profile("h2o generate", lambda: generate(
            params, cfg, prompts, **kw))}
    g = out["generate"]
    log(f"  h2o prefill {g['prefill_ms']:.2f} ms (runs "
        f"{[round(t, 2) for t in pre]}), decode {g['decode_ms']:.3f} ms a "
        f"step")

    mark("generate")

    # the engine
    trace = poisson_trace(cfg, **ENGINE_TRACE)
    ekw = dict(num_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
               layout="paged", page_size=ENGINE_PAGE)
    eng = ContinuousEngine(params, cfg, **ekw)
    torch.cuda.synchronize()
    reset_all_launches()
    comps = eng.run(trace)
    torch.cuda.synchronize()
    launches, st = all_launches(), eng.stats()
    steps = int(st["steps"])
    want = want_launches(
        flash_attention=L * len(trace), flash_decode=L * steps,
        rmsnorm_residual=(2 * L + 1) * (steps + len(trace)),
        swiglu=L * (steps + len(trace)))
    log(f"  h2o engine: { {k: round(v, 3) for k, v in st.items()} }; pool "
        f"bytes {pool_bytes(eng.cache)}; launches {launches}")
    if launches != want:
        raise AssertionError(f"h2o engine: launches {launches}, want {want}")
    bad = [r.id for r in trace
           if r.id not in comps or len(comps[r.id].tokens) != r.max_new_tokens]
    if sorted(comps) != [r.id for r in trace] or bad:
        raise AssertionError(f"h2o engine: requests incomplete {bad}")
    out["engine"] = {"stats": st, "launches": launches}
    del eng, comps
    gc.collect()
    torch.cuda.empty_cache()

    mark("engine")

    # the train step over all layers
    rows = lm_sequences(token_lm(TRAIN_SEED, vocab_size=cfg.vocab_size,
                                 n_tokens=TRAIN_B * TRAIN_T), TRAIN_T)
    batch = {"tokens": torch.as_tensor(rows, device="cuda").long()}
    want = want_launches(
        rmsnorm_residual=2 * L + 1, rmsnorm_residual_backward=2 * L + 1,
        swiglu=L, swiglu_backward=L, flash_attention_rope=L,
        flash_attention_backward=L)
    log(f"  h2o train step at {L} of {L} layers")
    del params      # train_steps gets the same weights anew, held by it alone
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = train_steps(f"{H2O_ARCH} {L} layers", cfg,
                               model_params(cfg), batch, want)
    out["train"]["layers"] = L
    mark("train")
    t = out["train"]
    log(f"  h2o train step ({t['layers']} of {L} layers): median "
        f"{t['step_ms']:.1f} ms, {t['tok_s']:.0f} tokens/s, peak "
        f"{t['peak_gib']:.2f} GiB; phase 37 seconds by part {secs}")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def h2o_kernel_line(h2o):
    """The changed kernels at width 120: ms a call (h2o_kernel_checks) and
    device ms and launches on h2o's path (the profiled generate and train
    step), each beside its bound."""
    runs = {"generate": h2o["generate"]["profile"],
            "train": h2o["train"]["breakdown"]}
    parts = []
    for name, (_, run, fam) in H2O_KERNELS.items():
        row = h2o["kernels"][name]["row"]
        lib = row["library_ms"]
        call = (f"{name} {row['ms']:.4f} ms a call (bound "
                f"{row['bound_ms']:.4f}, {row['bound_by']}; plain "
                f"{row['plain_ms']:.4f}, library "
                f"{'none' if lib is None else f'{lib:.4f}'})")
        if run is not None:
            r = runs[run]
            call += (f", {r['families'].get(fam, 0.0):.3f} ms and "
                     f"{r['calls'].get(fam, 0)} kernels in the profiled "
                     f"{run}")
        else:
            int8 = h2o["kernels"][name]["int8_row"]["ms"]
            call += (f"; int8 pool {int8:.4f} ms a call; not on h2o's path "
                     f"(every layer slides)")
        parts.append(call)
    return "h2o-danube-3-4b kernels at width 120: " + "; ".join(parts)


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
    t_start = time.perf_counter()
    took = {}

    def lap(name):
        took[name] = round(time.perf_counter() - t_start
                           - sum(took.values()), 1)

    try:
        from repro_torch.configs import F1_MNIST, RESNET44_CIFAR10
        from repro_torch.device import resolve_device
        resolve_device(None)
        smi = smi_line()
        log(f"card: {smi}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; tf32 matmul="
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
            f"{torch.backends.cudnn.allow_tf32}; cudnn deterministic="
            f"{torch.backends.cudnn.deterministic}")
        phase_build()
        lap("build")
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
        lap("slice 1")
        # slice 2: qwen3-1.7b serving
        kern = phase_serving_kernels()
        params = serve_params()
        serve = phase_serve(params)
        phase_serve_cuda_vs_cpu()
        lap("slice 2")
        # slice 3: continuous serving
        paged_err = phase_paged_kernel()
        engine = phase_engine(params)
        lap("engine")
        batch_invariance_probe(params)
        del params
        paged_timing = phase_paged_timing(engine["states"])
        lap("paged timing")
        phase_engine_cuda_vs_cpu()
        lap("engine cuda vs cpu")
        # slice 4: LM training
        train_kern = phase_train_kernels()
        lap("train kernels")
        train = phase_lm_train()
        lap("train")
        phase_train_cuda_vs_cpu()
        lap("train cuda vs cpu")
        # slice 5: falcon-mamba-7b (SSM) serving and training
        mamba_kern = phase_mamba_kernels()
        lap("mamba kernels")
        mamba_serve = phase_mamba_serve()
        mamba_invariance_probe()
        lap("mamba serve")
        mamba_train = phase_mamba_train()
        lap("mamba train")
        phase_mamba_cuda_vs_cpu()
        lap("mamba cuda vs cpu")
        # slice 6: the paper's sweeps through the experiments runner
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sweeps_") as tmp:
            sweeps = phase_sweep(tmp)
            lap("sweep")
            lm_sweeps = phase_lm_sweeps(tmp)
            lap("lm sweeps")
        # slice 7: the MoE family
        gc.collect()
        torch.cuda.empty_cache()
        moe_serve, moe_p = phase_moe_serve()
        lap("moe serve")
        moe_engine = phase_moe_engine(moe_p)
        del moe_p
        gc.collect()
        torch.cuda.empty_cache()
        lap("moe engine")
        moe_train = phase_moe_train()
        lap("moe train")
        phase_moe_cuda_vs_cpu()
        lap("moe cuda vs cpu")
        # slice 8: the encoder-decoder and vision-LM families, and jamba
        gc.collect()
        torch.cuda.empty_cache()
        memory_runs = {}
        memory_runs["seamless generate"] = phase_memory_serve(ENCDEC_ARCH)
        lap("seamless serve")
        memory_runs["seamless train"] = phase_memory_train(ENCDEC_ARCH)
        lap("seamless train")
        memory_runs["llama-vision generate"] = phase_memory_serve(VLM_ARCH)
        lap("llama-vision serve")
        memory_runs["llama-vision train"] = phase_memory_train(
            VLM_ARCH, VLM_TRAIN_LAYERS)
        lap("llama-vision train")
        memory_runs["jamba generate"], memory_runs["jamba engine"] = \
            phase_jamba()
        lap("jamba")
        phase_new_cuda_vs_cpu()
        lap("new configs cuda vs cpu")
        # slice 9: the parallel layer, 2 and 4 ranks sharing the card
        gc.collect()
        torch.cuda.empty_cache()
        mesh_dp = phase_mesh_dp()
        lap("mesh dp")
        mesh_lm = phase_mesh_lm()
        lap("mesh lm")
        mesh_ep = phase_mesh_ep()
        lap("mesh ep")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            phase_mesh_parity(tmp)
        lap("mesh parity")
        # slice 10: model-sharded serving and the launchers
        gc.collect()
        torch.cuda.empty_cache()
        phase_sharded_engine(engine)
        lap("sharded engine")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
            phase_launchers(tmp)
        lap("launchers")
        # slice 11: h2o-danube-3-4b at its published widths (head width 120)
        gc.collect()
        torch.cuda.empty_cache()
        h2o = phase_h2o()
        lap("h2o")
    except Exception:
        traceback.print_exc()
        log(f"chip_smoke failed {time.perf_counter() - t_start:.1f} s after "
            f"start-up (seconds by part before the failing one: {took})")
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    gbn = gbn_rows(rows, launches, errs)
    serving = serving_rows(kern, serve)
    paged = paged_row(paged_err, engine, paged_timing)
    training = train_rows(train_kern, train)
    mamba = mamba_rows(mamba_kern, mamba_serve, mamba_train)
    kernels = gbn + serving + [paged] + training + mamba
    log(f"resnet44 step (B={BATCH}): median warm step {step_ms:.2f} ms; "
        f"GBN kernels {gbn[0]['ms'] + gbn[1]['ms']:.3f} ms a step "
        f"(bound {gbn[0]['bound_ms'] + gbn[1]['bound_ms']:.3f} ms)")
    log(f"serve {SERVE_ARCH} (B={SERVE_B}, P={SERVE_P} ragged, {SERVE_NEW} "
        f"new tokens): generate {serve['wall_ms']:.1f} ms, prefill "
        f"{serve['prefill_ms']:.2f} ms, decode {serve['decode_ms']:.3f} ms "
        f"a step, {SERVE_B * SERVE_NEW / serve['wall_ms'] * 1e3:.1f} new "
        f"tokens/s, peak {serve['peak_gib']:.2f} GiB; serving kernels per "
        f"generate " + ", ".join(f"{r['name']} {r['ms']:.2f} ms (bound "
                                 f"{r['bound_ms']:.3f})" for r in serving))
    st, base = engine["bf16"]["stats"], engine["static"]
    tok_s = {k: [engine[k][s_]["useful_tok_s"]
                 for s_ in ("stats", "repeat_stats")]
             for k in ("bf16", "int8")}
    iso = {k: sum(t[k] for t in paged_timing) / len(paged_timing)
           for k in ("ms", "int8_ms")}
    n_paged = paged["launches"]
    log(f"engine {SERVE_ARCH} ({ENGINE_LAYERS} of 28 layers, 16 slots, "
        f"paged, {ENGINE_TRACE['n_requests']} requests, {st['steps']:.0f} "
        f"steps): useful tokens/s bf16 "
        f"{tok_s['bf16'][0]:.1f} and {tok_s['bf16'][1]:.1f}, int8 "
        f"{tok_s['int8'][0]:.1f} and {tok_s['int8'][1]:.1f} (runs in the "
        f"order bf16, int8, int8, bf16), agreement "
        f"{engine['int8_agreement']:.4f}; lockstep baseline "
        f"{base['useful_tok_s']:.1f} useful tokens/s; flash_decode_paged "
        f"over the bf16 run {paged['ms']:.2f} ms "
        f"({paged['ms'] / n_paged * 1e3:.1f} us a call; alone on cold "
        f"pools {iso['ms'] * 1e3:.1f} us), bound "
        f"{paged['bound_ms']:.3f} ms; over the int8 run "
        f"{engine['int8']['run_profile']['families']['flash_decode_paged']:.2f}"
        f" ms (alone {iso['int8_ms'] * 1e3:.1f} us a call), bound "
        f"{engine['int8']['bound'][0]:.3f} ms")
    log(f"train {SERVE_ARCH} (bf16, B={TRAIN_B}, T={TRAIN_T}): median step "
        f"{train['step_ms']:.1f} ms, {train['tok_s']:.0f} tokens/s, peak "
        f"{train['peak_gib']:.2f} GiB ({train['step_peak_gib']:.2f} above "
        f"the step's input state; remat {train['remat_peak_gib']:.2f}); "
        f"training kernels per step " + ", ".join(
            f"{r['name']} {r['ms']:.2f} ms (bound {r['bound_ms']:.3f})"
            for r in training))
    ms_, mt_ = mamba_serve, mamba_train
    log(f"serve {MAMBA_ARCH} (B={SERVE_B}, P={SERVE_P} ragged, {SERVE_NEW} "
        f"new tokens): generate {ms_['wall_ms']:.1f} ms, prefill "
        f"{ms_['prefill_ms']:.2f} ms, decode {ms_['decode_ms']:.3f} ms a "
        f"step, {SERVE_B * SERVE_NEW / ms_['wall_ms'] * 1e3:.1f} new "
        f"tokens/s, peak {ms_['peak_gib']:.2f} GiB; train "
        f"{MAMBA_TRAIN_LAYERS} layers (bf16, B={TRAIN_B}, T={TRAIN_T}): "
        f"median step {mt_['step_ms']:.1f} ms, {mt_['tok_s']:.0f} tokens/s, "
        f"peak {mt_['peak_gib']:.2f} GiB ({mt_['step_peak_gib']:.2f} above "
        f"the step's input state; remat {mt_['remat_peak_gib']:.2f}); "
        + ", ".join(f"{r['name']} {r['ms']:.2f} ms (bound "
                    f"{r['bound_ms']:.3f}, {r['launches']} launches)"
                    for r in mamba))
    log(f"generalization-gap sweep ({RESNET44_CIFAR10.name}, B={BATCH}): "
        f"{sweeps['sweep_s']:.1f} s; " + ", ".join(
            f"{m} {r['steps']} steps {r['wall_s']:.2f} s ({r['step_ms']:.2f} "
            f"ms a step)" for m, r in sweeps["runs"].items())
        + f"; kill + resume {sweeps['killed_s']:.2f} + "
        f"{sweeps['resumed_s']:.2f} s; skip pass {sweeps['skip_s']:.2f} s; "
        f"lm-smoke sweeps " + ", ".join(f"{a} {s:.1f} s"
                                        for a, s in lm_sweeps.items()))
    moe_summary(moe_serve, moe_engine, moe_train)
    memory_summary(memory_runs)
    mesh_kernel_line(mesh_dp, mesh_lm, mesh_ep)
    g, t = h2o["generate"], h2o["train"]
    log(f"h2o-danube-3-4b (bf16, hd 120, 24 layers; the train step at "
        f"{t['layers']} layers): generate {g['wall_ms']:.1f} ms, prefill "
        f"{g['prefill_ms']:.2f} ms, decode {g['decode_ms']:.3f} ms a step, "
        f"peak {g['peak_gib']:.2f} GiB; engine "
        f"{h2o['engine']['stats']['useful_tok_s']:.1f} useful tokens/s; "
        f"train step "
        f"{t['step_ms']:.1f} ms, {t['tok_s']:.0f} tokens/s, peak "
        f"{t['peak_gib']:.2f} GiB")
    log(h2o_kernel_line(h2o))
    log(norm_width_line(kern["rmsnorm_residual"]["widths"],
                        train_kern["rmsnorm_residual_backward"]["widths"]))
    log(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s after start-up"
        f" (seconds by part: {took})")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
