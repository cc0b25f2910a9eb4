"""Batched serving (the port of ``repro.serving.engine``): a fused prefill,
then a KV-cache decode loop, and the continuous-batching engine.

- **prefill** is one full-sequence forward
  (:func:`repro_torch.models.transformer.prefill_forward`) that writes
  every layer's K/V into the cache and keeps the last position's logits;
- **decode** is one token per step (:func:`make_serve_step`); with
  ``use_kernels=True`` (the default) the cache is head-major and attention
  runs in the flash-decode kernel with the query's RoPE fused in;
- ragged prompts are LEFT-padded with ``prompt_lens``: the padding is
  masked out of every attention and RoPE positions start at each row's
  first real token, so each row continues as it would unpadded;
- an encoder-decoder or vision-LM model is given its ``memory`` (the
  encoder's output, or the image embeddings): it is projected once into
  the cross blocks' cache before the prefill.

The decode loop is a Python loop that never waits on the card: tokens stay
on the device, and ``prompt_lens`` is checked on the host before it is
sent. The token-at-a-time :func:`prefill` is the cross-checking fallback
of the fused one.

:class:`ContinuousEngine` serves a stream of requests over a fixed pool of
decode slots: each row advances at its own position, retires on EOS or its
budget, and its slot is refilled mid-flight (see its docstring).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ref import quantize_slots
from repro_torch.models import blocks as B
from repro_torch.models import transformer as T
from repro_torch.obs.trace import NULL_TRACER

Params = Any
Tensor = torch.Tensor


def mask_padded_vocab(cfg: ModelConfig, logits: Tensor) -> Tensor:
    """-inf the padded-vocab tail so no sampler can emit an id >=
    vocab_size."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits.clone()
        logits[..., cfg.vocab_size:] = -torch.inf
    return logits


def sample_tokens(cfg: ModelConfig, logits: Tensor, *,
                  temperature: float = 0.0, top_k: int = 0,
                  generator: Optional[torch.Generator] = None,
                  rows: Optional[Tuple[int, int]] = None) -> Tensor:
    """logits (B, V) -> token ids (B,) int64.

    ``temperature <= 0`` is exact greedy argmax; otherwise a draw from
    ``softmax(logits / temperature)`` (Gumbel-max with uniforms from
    ``generator``, on the logits' device), optionally restricted to the
    ``top_k`` largest logits. Padded-vocab ids are masked in every mode.
    ``rows=(first, total)``: the logits are rows [first, first + B) of a
    batch of ``total`` rows; the uniforms are drawn for the whole batch
    and these rows kept, so a batch split over ranks samples as the whole
    batch would."""
    logits = mask_padded_vocab(cfg, logits.float())
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("temperature sampling requires a generator (the "
                         "rng)")
    if top_k > 0:
        k_eff = min(top_k, cfg.vocab_size)        # the padded tail is -inf
        kth = torch.topk(logits, k_eff, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if rows is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    else:
        first, total = rows
        u = torch.rand((total, logits.shape[-1]), generator=generator,
                       device=logits.device)[first:first + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u))
    return (logits / temperature + gumbel).argmax(dim=-1)


def make_serve_step(cfg: ModelConfig, use_kernels: bool = True,
                    temperature: float = 0.0, top_k: int = 0) -> Callable:
    """(params, cache, tokens (B, 1), pos[, generator, offsets, rows])
    -> (next_tokens (B, 1), cache); ``rows`` as :func:`sample_tokens`."""

    def serve_step(params: Params, cache: Params, tokens: Tensor,
                   pos: Union[int, Tensor],
                   generator: Optional[torch.Generator] = None,
                   offsets: Optional[Tensor] = None,
                   rows: Optional[Tuple[int, int]] = None
                   ) -> Tuple[Tensor, Params]:
        logits, cache = T.decode_step(params, cfg, tokens, cache, pos,
                                      use_kernels=use_kernels,
                                      offsets=offsets)
        nxt = sample_tokens(cfg, logits[:, -1], temperature=temperature,
                            top_k=top_k, generator=generator, rows=rows)
        return nxt[:, None], cache

    return serve_step


def prefill(params: Params, cfg: ModelConfig, prompts: Tensor,
            cache: Params, *, use_kernels: bool = True
            ) -> Tuple[Tensor, Params]:
    """Token-at-a-time prefill fallback: the prompt fed through decode
    steps at positions 0..P-1. Returns (last-position logits (B,
    padded_vocab), cache). The fused :func:`prefill_fused` supersedes it;
    it stays as the independently coded cross-check."""
    last = None
    for t in range(prompts.shape[1]):
        logits, cache = T.decode_step(params, cfg, prompts[:, t:t + 1],
                                      cache, t, use_kernels=use_kernels)
        last = logits[:, -1]
    return last, cache


def prefill_fused(params: Params, cfg: ModelConfig, prompts: Tensor,
                  cache: Params, *, offsets: Optional[Tensor] = None,
                  use_kernels: bool = True) -> Tuple[Tensor, Params]:
    """One full-sequence forward fills the cache. Returns (last-position
    logits (B, padded_vocab), cache)."""
    logits, cache = T.prefill_forward(params, cfg, prompts, cache,
                                      use_kernels=use_kernels,
                                      offsets=offsets)
    return logits[:, -1], cache


def _offsets(prompt_lens: Union[Sequence[int], np.ndarray, Tensor], B: int,
             P: int, device: torch.device) -> Tensor:
    """Left pads ``P - prompt_lens``, checked on the host, sent once."""
    if isinstance(prompt_lens, Tensor):
        prompt_lens = prompt_lens.cpu()
    lens = np.asarray(prompt_lens, dtype=np.int64).reshape(-1)
    if lens.shape != (B,) or ((lens < 1) | (lens > P)).any():
        raise ValueError(f"prompt_lens must be {B} lengths in [1, {P}] (the "
                         f"padded prompt width); got {lens.tolist()}")
    return torch.as_tensor((P - lens).astype(np.int32), device=device)


def generate(params: Params, cfg: ModelConfig,
             prompts: Union[Tensor, np.ndarray], *, max_new_tokens: int = 32,
             max_len: Optional[int] = None, memory: Optional[Tensor] = None,
             use_kernels: bool = True,
             temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             prompt_lens: Optional[Union[Sequence[int], Tensor]] = None,
             fused_prefill: bool = True, device: DeviceLike = None
             ) -> Tensor:
    """Batched generation: prompts (B, P) -> (B, P + max_new_tokens) on
    ``device`` (the card unless told otherwise; ``params`` must live there).

    ``temperature == 0`` is greedy; ``temperature > 0`` samples with
    ``generator`` (required, on ``device``), optionally top-k truncated
    (``top_k`` is clamped to ``vocab_size``). ``prompt_lens`` (B,) marks
    LEFT-padded ragged prompts: row b's real tokens are its last
    ``prompt_lens[b]`` columns. ``max_len`` (when given) is the cache depth
    and must cover the prompt and every new token, or this raises.
    ``max_new_tokens == 0`` returns the prompts unchanged.
    ``fused_prefill=False`` fills the cache token by token
    (:func:`prefill`); ragged prompts need the fused prefill. ``memory``
    (B, S, d_model) is what the cross blocks attend: the cache gets
    ``S`` cross slots, filled by
    :func:`repro_torch.models.transformer.build_cross_cache`, before the
    prefill; it masks nothing."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape
    total = P + max_new_tokens if max_len is None else max_len
    if total < P + max_new_tokens:
        raise ValueError(
            f"max_len={total} is shallower than prompt ({P}) + "
            f"max_new_tokens ({max_new_tokens}) = {P + max_new_tokens}; "
            f"decode steps would write past the cache depth")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a generator (the rng)")
    if prompt_lens is not None and not fused_prefill:
        raise ValueError(
            "ragged prompts (prompt_lens) require the fused prefill")
    offsets = None if prompt_lens is None else _offsets(prompt_lens, B, P,
                                                         dev)
    if max_new_tokens == 0:
        return prompts
    cache = T.init_cache(cfg, B, total, layout="head" if use_kernels
                         else "seq", device=dev,
                         memory_len=0 if memory is None else memory.shape[1])
    if memory is not None:
        cache = T.build_cross_cache(params, cfg, memory, cache)
    if fused_prefill:
        last, cache = prefill_fused(params, cfg, prompts, cache,
                                    offsets=offsets, use_kernels=use_kernels)
    else:
        last, cache = prefill(params, cfg, prompts, cache,
                              use_kernels=use_kernels)
    step = make_serve_step(cfg, use_kernels, temperature, top_k)
    tok = sample_tokens(cfg, last, temperature=temperature, top_k=top_k,
                        generator=generator)[:, None]
    out = [prompts, tok.to(prompts.dtype)]
    # the prefill sampled token P, so N - 1 decode steps remain
    for i in range(max_new_tokens - 1):
        tok, cache = step(params, cache, tok, P + i, generator=generator,
                          offsets=offsets)
        out.append(tok.to(prompts.dtype))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One serving request. ``arrival`` is in decode-step units (the
    engine's simulated clock): the request becomes visible to the scheduler
    once that many decode steps have executed."""
    id: int
    prompt: Any                     # (L,) int token ids (list / numpy)
    max_new_tokens: int
    arrival: float = 0.0


@dataclasses.dataclass
class Completion:
    """Finished request: the generated continuation (prompt excluded) and
    the decode-step clock at which the row retired."""
    id: int
    tokens: list
    finished_at: float


def _prompt_len(req: Request) -> int:
    return int(np.asarray(req.prompt).shape[0])


def _page_blocks(src: Tensor, ps: int) -> Tensor:
    """A batch-1 head-major ``kh``/``vh`` leaf (1, kv, S, hd) as page-sized
    blocks (S // ps, kv, ps, hd)."""
    t = src[0]
    kv, S, hd = t.shape
    return t.reshape(kv, S // ps, ps, hd).transpose(0, 1)


def _scatter_admit(cache: Params, tmp: Params, cfg: ModelConfig,
                   slot: Optional[int], pages: Tensor) -> None:
    """Scatter a freshly prefilled batch-1 contiguous cache ``tmp`` into row
    ``slot`` of the serving cache, in place.

    Contiguous leaves (``kh``/``vh`` rings, "seq" ``k``/``v``) are a row
    copy (none when ``slot`` is None: the row lives on another data rank
    of a sharded engine). A paged layer cuts the temp cache's head-major
    ``kh``/``vh`` into
    page-sized blocks and writes the prompt's blocks at ``pages`` (the
    row's freshly allocated pages, one per block of the prompt); an int8
    pool quantizes each slot on the way in (:func:`quantize_slots`, the
    reference's ``_slot_scales`` rule) and writes its scales at
    ``ks``/``vs``. Only allocated pages are written, so no block lands on
    the trash page 0. The block table is written by :func:`_write_pt`."""
    n = pages.shape[0]
    for (_, dst_block), (_, src_block) in zip(B.each_layer(cache, cfg),
                                              B.each_layer(tmp, cfg)):
        for key, dst in dst_block.items():
            src = src_block[key]
            if "pt" not in dst:
                if slot is not None:
                    for name, leaf in dst.items():
                        leaf[slot] = src[name][0].to(leaf.dtype)
                continue
            ps = dst["kp"].shape[2]
            for pool, scales, full in (("kp", "ks", "kh"), ("vp", "vs", "vh")):
                blocks = _page_blocks(src[full], ps)[:n]
                if scales in dst:
                    codes, sc = quantize_slots(blocks)
                    dst[pool][pages] = codes
                    dst[scales][pages] = sc
                else:
                    dst[pool][pages] = blocks.to(dst[pool].dtype)


def _write_pt(cache: Params, cfg: ModelConfig, pt: Tensor) -> None:
    """Overwrite every layer's block table with ``pt`` (num_slots, NB), in
    place: the engine keeps ONE logical table for all layers (each layer
    has its own page pool, addressed by the same page ids). A table shared
    by several layers is written once."""
    done = set()
    for _, block in B.each_layer(cache, cfg):
        for c in block.values():
            if "pt" in c and id(c["pt"]) not in done:
                done.add(id(c["pt"]))
                c["pt"].copy_(pt)


class ContinuousEngine:
    """Continuous-batching scheduler over a fixed pool of decode slots (the
    port of ``repro.serving.ContinuousEngine``).

    The static engine (:func:`generate`) decodes one batch in lockstep: a
    single long request holds every freed slot hostage until the whole
    batch drains. Here each row advances at its OWN position (a per-row
    ``pos`` vector through :func:`repro_torch.models.transformer.
    decode_step` into the decode kernels), a row that emits EOS or reaches
    its token budget RETIRES immediately, and the freed slot is refilled
    mid-flight by prefilling the next queued request into just that row
    (:func:`prefill_fused` on a batch-1 temp cache, scattered in by
    :func:`_scatter_admit`).

    ``layout="paged"`` backs full-attention layers with a page pool and
    per-row block tables (``models.layers.init_kv_cache``): pages come from
    a host-side free list as rows grow and return on retirement, so cache
    memory is bounded by the tokens in flight, not num_slots x worst-case
    length. A retired row's table is zeroed: its (dead) decode writes land
    on the trash page 0, which no visible slot reaches. "head" and "seq"
    are the contiguous layouts. ``cache_dtype="int8"`` quantizes the paged
    pool per slot (f32 ``ks``/``vs`` scales): the pool's payload bytes
    halve; admission quantizes the prefilled blocks and the decode kernel
    dequantizes at the load.

    Host/device split: ``pos``/``active``/the block table/the queues live
    on the host (numpy). A step copies ``pos`` to the device once, runs one
    decode step over all slots (the cache is updated in place) and fetches
    the step's tokens once. Retired rows keep stepping, their ``pos``
    frozen and output discarded: the raw-vs-useful gap ``stats()`` reports
    as ``dropped_tokens``.

    ``obs`` (a :class:`repro_torch.obs.Observability`) instruments the loop
    with the reference's spans (``serve.run``, ``serve.admit``,
    ``serve.decode_step``, ``serve.page_alloc``) and ``serve/*`` metrics:
    ``serve/ttft_s``, ``serve/itl_s``, ``serve/e2e_s``,
    ``serve/step_time_s``, ``serve/queue_depth``, ``serve/slot_occupancy``,
    ``serve/page_pool_util``, ``serve/completions`` and, at the end of a
    run, every ``stats()`` key. Without ``obs`` every span is the tracer's
    no-op singleton.

    ``temperature > 0`` samples with ``generator`` (a ``torch.Generator``
    on ``device``), else greedy. The engine runs on ``device`` (the card
    unless told otherwise), where ``params`` must live.

    ``mesh=`` (a :class:`repro_torch.launch.mesh.Mesh` with a "model"
    axis, every rank of it constructing the engine alike from the same
    whole ``params``, with no ``device``: the engine runs on the mesh's)
    serves one model across ranks. Each rank keeps its
    Megatron slice of the attention heads and of the dense MLP
    (``train.parallel.mesh_param_specs(tp=True)``, no FSDP; embedding
    and LM head replicated) and its slice of the cache by
    ``sharding.rules.cache_specs``: its kv heads of every page pool (and
    int8 scales), and, when the slots divide over the data axes, its
    rows of the block table. Every rank runs the same host scheduler
    (queue, pages, block table, retirement); its decisions are
    deterministic, so they agree without messages. A data rank decodes
    its rows; the step's tokens are gathered over the data axes
    (``all_gather``) so every scheduler sees every row. Admission
    prefills on every rank (the pool is replicated over data). Sampling
    draws the whole batch's uniforms on every rank and keeps the rank's
    rows, so the tokens are the unsharded engine's for the same seed.
    Each attention and MLP sublayer sums its partial output over "model"
    (``core.expert_parallel.region_out``): two sums a layer a step. MoE
    and SSM blocks raise here (the reference's engine serves them under
    GSPMD), as do head counts that do not divide the model axis (the
    sequence-sharded cache the reference falls back to needs a softmax
    across ranks).
    """

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 num_slots: int, max_len: int, layout: str = "paged",
                 page_size: int = 16, total_pages: Optional[int] = None,
                 cache_dtype: Optional[str] = None,
                 use_kernels: bool = True, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 generator: Optional[torch.Generator] = None, obs=None,
                 mesh=None, device: DeviceLike = None):
        if any(s.cross_attn for s in (tuple(cfg.head_pattern)
                                      + tuple(cfg.body_pattern)
                                      + tuple(cfg.tail_pattern))):
            raise ValueError("ContinuousEngine serves decoder-only models "
                             "(no cross-attention memory)")
        if layout not in ("paged", "head", "seq"):
            raise ValueError(f"unknown layout {layout!r}")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature > 0 requires a generator (the rng)")
        self.mesh = mesh
        self._rows: Tuple[int, int] = (0, num_slots)   # this rank's slots
        self._row_axes: Tuple[str, ...] = ()
        self._kv_heads = cfg.n_kv_heads
        if mesh is not None:
            params = self._shard(params, cfg, mesh, num_slots, device)
            device = mesh.device
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.layout = layout
        self.cache_dtype = cache_dtype
        self.use_kernels = use_kernels
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.generator = generator
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else NULL_TRACER
        self._reg = obs.registry if obs is not None else None
        self.paged = layout == "paged"
        if self.paged:
            if max_len % page_size != 0:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of "
                    f"page_size={page_size}")
            self.page_size = page_size
            self.n_blocks = max_len // page_size
            default_pages = 1 + num_slots * self.n_blocks
            self.total_pages = (total_pages if total_pages is not None
                                else default_pages)
            if self.total_pages < 1 + self.n_blocks:
                raise ValueError(
                    f"total_pages={self.total_pages} cannot hold even one "
                    f"full-length row (+ trash page)")
        else:
            self.page_size = self.n_blocks = self.total_pages = 0
        self._step_fn = make_serve_step(cfg, use_kernels, temperature, top_k)
        self.reset()

    def _shard(self, params: Params, cfg: ModelConfig, mesh, num_slots: int,
               device: DeviceLike) -> Params:
        """Check that ``cfg`` can be served on ``mesh``, set this rank's
        rows and kv heads, and return its slices of ``params``."""
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.sharding import rules
        from repro_torch.train import parallel as PAR
        names = getattr(mesh, "axis_names", ())
        if mesh_lib.MODEL_AXIS not in names:
            raise ValueError(f"a serving mesh needs a "
                             f"{mesh_lib.MODEL_AXIS!r} axis; got {mesh!r}")
        if device is not None:
            raise ValueError(f"device={device}: on a mesh the engine runs "
                             f"on the mesh's device ({mesh.device})")
        specs = tuple(cfg.head_pattern) + tuple(cfg.body_pattern) \
            + tuple(cfg.tail_pattern)
        if any(s.ff == "moe" or s.mixer == "ssm" for s in specs):
            raise NotImplementedError(
                "model-sharded serving covers attention and dense MLP "
                "blocks: the reference's engine serves MoE and SSM blocks "
                "under GSPMD (experts and d_inner over 'model', its "
                "compiler's collectives), which the port's serving regions "
                "do not replace")
        msize = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
        if cfg.n_heads % msize or cfg.n_kv_heads % msize:
            raise NotImplementedError(
                f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads do not split "
                f"over a model axis of {msize}: the reference then shards "
                f"the cache's sequence and all-reduces the decode softmax, "
                f"which the port does not serve")
        self._kv_heads = cfg.n_kv_heads // msize
        axes = mesh_lib.spec_axes(rules.batch_spec(mesh, num_slots)[0])
        n_local = num_slots // mesh.axis_size(axes)
        first = mesh.index(axes) * n_local
        self._rows, self._row_axes = (first, first + n_local), axes
        pspecs = PAR.mesh_param_specs(params, mesh, cfg=cfg, tp=True)
        return PAR.shard_tree(mesh, params, pspecs)

    def _region(self):
        """The model's manual region on the mesh (a no-op without one)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.core import expert_parallel as EP
        from repro_torch.launch import mesh as mesh_lib
        return EP.manual_mode(
            mesh_lib.MODEL_AXIS,
            mesh_lib.axis_size(self.mesh, mesh_lib.MODEL_AXIS), (),
            self.mesh)

    def _local_row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's cache, None on another data
        rank."""
        first, end = self._rows
        return slot - first if first <= slot < end else None

    # -- state ---------------------------------------------------------------

    def reset(self) -> None:
        cfg, n = self.cfg, self.num_slots
        kw = dict(layout=self.layout, page_size=self.page_size or 64,
                  total_pages=self.total_pages or None,
                  cache_dtype=self.cache_dtype)
        if self.mesh is None:
            self.cache = T.init_cache(cfg, n, self.max_len,
                                      device=self.device, **kw)
        else:
            from repro_torch.sharding import rules
            whole = T.init_cache(cfg, n, self.max_len, device="meta", **kw)
            self.cache = rules.cache_slice(
                self.mesh, whole, rules.cache_specs(whole, self.mesh, n))
        self.pos = np.zeros((n,), np.int32)
        self.active = np.zeros((n,), bool)
        first, end = self._rows
        self._last = torch.zeros((end - first, 1), dtype=torch.long,
                                 device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n
        if self.paged:
            self.pt_host = np.zeros((n, self.n_blocks), np.int32)
            self.free_pages = list(range(self.total_pages - 1, 0, -1))
        self.queue: List[Request] = []      # admissible requests, FIFO
        self.pending: List[Request] = []    # future arrivals, sorted
        self.completions: Dict[int, Completion] = {}
        self._generated: Dict[int, list] = {}
        self.clock = 0.0              # decode steps executed
        self.steps = 0
        self.tokens_out = 0           # useful: tokens delivered to requests
        self.tokens_raw = 0           # every token the model decoded
        self.tokens_dropped = 0       # retired-lane tokens thrown away
        self._enq_wall: Dict[int, float] = {}   # req id -> queue-entry wall
        self._run_t0 = time.perf_counter()
        self._run_elapsed = 0.0       # frozen at run() end

    # -- scheduling ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        L = _prompt_len(req)
        if L < 1 or L + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.id}: prompt ({L}) + max_new_tokens "
                f"({req.max_new_tokens}) must fit max_len={self.max_len}")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.id}: max_new_tokens must be >= 1")
        self._enqueue(req)

    def _enqueue(self, req: Request) -> None:
        """Make a request visible to the scheduler; the wall clock here is
        the zero point for its TTFT/e2e latencies."""
        self.queue.append(req)
        self._enq_wall.setdefault(req.id, time.perf_counter())

    def _pages_for(self, n_needed: int, row: int) -> bool:
        """Allocate pages for row blocks [0, n_needed) that are still on the
        trash page. Returns False if the pool is exhausted."""
        for i in range(n_needed):
            if self.pt_host[row, i] == 0:
                if not self.free_pages:
                    return False
                self.pt_host[row, i] = self.free_pages.pop()
        return True

    def _sync_pt(self) -> None:
        first, end = self._rows
        _write_pt(self.cache, self.cfg,
                  torch.as_tensor(self.pt_host[first:end],
                                  device=self.device))

    def _admit(self, req: Request, slot: int) -> bool:
        cfg, dev = self.cfg, self.device
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=dev)
        L = int(prompt.shape[0])
        with self._tracer.span("serve.admit", req=req.id, prompt_len=L,
                               slot=slot):
            n = -(-L // self.page_size) if self.paged else 0
            if self.paged and not self._pages_for(n, slot):
                return False               # pool exhausted; stay queued
            # the temp cache is head-major wherever the main cache is:
            # pages are cut from head-major blocks, and contiguous leaves
            # are copied row for row
            tmp = T.init_cache(cfg, 1, self.max_len,
                               layout="seq" if self.layout == "seq"
                               else "head", device=dev,
                               kv_heads=self._kv_heads)
            with self._region():
                last, tmp = prefill_fused(self.params, cfg, prompt[None],
                                          tmp, use_kernels=self.use_kernels)
            tok = sample_tokens(cfg, last, temperature=self.temperature,
                                top_k=self.top_k, generator=self.generator)
            if self.paged:
                self._sync_pt()
            pages = torch.as_tensor(self.pt_host[slot, :n] if self.paged
                                    else np.zeros((0,), np.int32),
                                    device=dev).long()
            row = self._local_row(slot)
            _scatter_admit(self.cache, tmp, cfg, row, pages)
            if row is not None:
                self._last[row] = tok
            first = tok.tolist()[0]
        self.pos[slot] = L
        self.active[slot] = True
        self.slot_req[slot] = req
        self._generated[req.id] = []
        self.tokens_out += 1
        self.tokens_raw += 1
        if self._reg is not None:
            # the admission prefill sampled the request's FIRST token
            wall = time.perf_counter()
            self._reg.observe("serve/ttft_s",
                              wall - self._enq_wall.get(req.id, wall))
        self._record(slot, first)
        return True

    def _record(self, slot: int, tok: int) -> None:
        """Append one generated token to the slot's request; retire on EOS
        or budget exhaustion."""
        req = self.slot_req[slot]
        out = self._generated[req.id]
        out.append(tok)
        if ((self.eos_id is not None and tok == self.eos_id)
                or len(out) >= req.max_new_tokens):
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.completions[req.id] = Completion(
            id=req.id, tokens=list(self._generated.pop(req.id)),
            finished_at=self.clock)
        self.active[slot] = False     # pos intentionally frozen
        self.slot_req[slot] = None
        enq = self._enq_wall.pop(req.id, None)
        if self._reg is not None and enq is not None:
            self._reg.observe("serve/e2e_s", time.perf_counter() - enq)
            self._reg.inc("serve/completions")
        if self.paged:
            row = self.pt_host[slot]
            self.free_pages.extend(int(p) for p in row[row != 0])
            self.pt_host[slot] = 0
            self._sync_pt()

    def _release_arrivals(self) -> None:
        while self.pending and self.pending[0].arrival <= self.clock:
            self._enqueue(self.pending.pop(0))

    def _admit_ready(self) -> None:
        free = [s for s in range(self.num_slots) if not self.active[s]]
        while free and self.queue:
            if not self._admit(self.queue[0], free[0]):
                break                 # page pool exhausted: wait for frees
            self.queue.pop(0)
            free.pop(0)

    def _ensure_pages(self) -> None:
        """Pre-step page allocation: every active row is about to write its
        K/V at slot ``pos``; make sure the block holding it is backed."""
        dirty = 0
        for s in range(self.num_slots):
            if not self.active[s]:
                continue
            blk = int(self.pos[s]) // self.page_size
            if blk < self.n_blocks and self.pt_host[s, blk] == 0:
                if not self.free_pages:
                    raise RuntimeError(
                        "page pool exhausted mid-decode: total_pages too "
                        "small for the admitted working set")
                self.pt_host[s, blk] = self.free_pages.pop()
                dirty += 1
        if dirty:
            with self._tracer.span("serve.page_alloc", pages=dirty):
                self._sync_pt()

    # -- the loop ------------------------------------------------------------

    def step(self) -> None:
        """One decode step over all slots (active rows advance; retired
        rows write into masked slots / the trash page and are ignored)."""
        t0 = time.perf_counter()
        with self._tracer.span("serve.decode_step", step=self.steps):
            if self.paged:
                self._ensure_pages()
            first, end = self._rows
            pos = torch.tensor(self.pos[first:end], device=self.device)
            with self._region():
                toks, self.cache = self._step_fn(
                    self.params, self.cache, self._last, pos,
                    self.generator, rows=(first, self.num_slots))
            self._last = toks
            if self._row_axes:
                from repro_torch.launch import collectives as C
                toks = C.all_gather(toks, self._row_axes, self.mesh, 0)
            host = toks[:, 0].tolist()
        was_active = [s for s in range(self.num_slots) if self.active[s]]
        self.steps += 1
        self.clock += 1.0
        # every lane decoded a token; only active lanes delivered one
        self.tokens_raw += self.num_slots
        self.tokens_dropped += self.num_slots - len(was_active)
        if self._reg is not None:
            dt = time.perf_counter() - t0
            reg = self._reg
            reg.observe("serve/step_time_s", dt)
            itl = reg.histogram("serve/itl_s")
            for _ in was_active:   # each active row got one token this tick
                itl.observe(dt)
            reg.observe("serve/queue_depth", len(self.queue))
            reg.observe("serve/slot_occupancy",
                        len(was_active) / self.num_slots)
            if self.paged:
                in_use = self.total_pages - 1 - len(self.free_pages)
                reg.observe("serve/page_pool_util",
                            in_use / (self.total_pages - 1))
        for s in was_active:
            self.pos[s] += 1
            self.tokens_out += 1
            self._record(s, host[s])

    def run(self, requests: Sequence[Request]) -> Dict[int, Completion]:
        """Drive the arrival queue to completion: admit requests as their
        ``arrival`` clock passes and slots free up, decode until every
        request has finished. Returns {request id: Completion}."""
        self.reset()
        self.pending = sorted(requests, key=lambda r: r.arrival)
        for r in self.pending:
            L = _prompt_len(r)
            if L < 1 or r.max_new_tokens < 1 \
                    or L + r.max_new_tokens > self.max_len:
                raise ValueError(f"request {r.id} does not fit max_len="
                                 f"{self.max_len}")
        with self._tracer.span("serve.run", requests=len(self.pending)):
            while self.pending or self.queue or self.active.any():
                self._release_arrivals()
                self._admit_ready()
                if not self.active.any():
                    if self.pending:  # idle: jump the clock to next arrival
                        self.clock = max(self.clock, self.pending[0].arrival)
                        continue
                    break             # queue non-empty but nothing admitted
                self.step()
        if self.queue:
            raise RuntimeError(
                f"{len(self.queue)} requests could never be admitted "
                f"(prompt longer than any slot's page budget?)")
        self._run_elapsed = time.perf_counter() - self._run_t0
        if self._reg is not None:
            for name, value in self.stats().items():
                self._reg.set(f"serve/{name}", value)
        return self.completions

    def stats(self) -> Dict[str, float]:
        """Throughput accounting for the last/current ``run``: raw tok/s is
        every token the model decoded (dead retired lanes included);
        useful tok/s counts only tokens delivered to a request — the gap
        (``dropped_tokens``) is the engine's wasted work."""
        elapsed = max(self._run_elapsed
                      or time.perf_counter() - self._run_t0, 1e-9)
        return {"steps": float(self.steps),
                "useful_tokens": float(self.tokens_out),
                "raw_tokens": float(self.tokens_raw),
                "dropped_tokens": float(self.tokens_dropped),
                "useful_tok_s": self.tokens_out / elapsed,
                "raw_tok_s": self.tokens_raw / elapsed,
                "elapsed_s": elapsed}


def poisson_trace(cfg: ModelConfig, n_requests: int, *, rate: float,
                  prompt_len_choices=(8, 16, 24),
                  new_token_choices=(4, 16, 32),
                  seed: int = 0) -> List[Request]:
    """Synthetic serving trace: inter-arrival times are exponential(1/rate)
    in decode-step units (a Poisson process over the engine clock); prompt
    and output lengths are drawn uniformly from the given choice sets. The
    same numpy draws as the reference, so a seed gives the same trace."""
    r = np.random.RandomState(seed)
    t, out = 0.0, []
    for i in range(n_requests):
        t += float(r.exponential(1.0 / rate))
        L = int(r.choice(prompt_len_choices))
        N = int(r.choice(new_token_choices))
        prompt = r.randint(0, cfg.vocab_size, size=(L,)).astype("int32")
        out.append(Request(id=i, prompt=prompt, max_new_tokens=N, arrival=t))
    return out


def run_static_trace(params: Params, cfg: ModelConfig,
                     requests: Sequence[Request], *, batch: int,
                     max_len: int, use_kernels: bool = True,
                     device: DeviceLike = None) -> int:
    """Static-batch baseline for the same trace: serve requests in arrival
    order in fixed lockstep groups of ``batch`` via :func:`generate`.

    Every group is padded to ONE shape — (batch, P_max) left-padded prompts
    (ragged via ``prompt_lens``) decoding N_max tokens; the tail group is
    padded by repeating its last request — so each group runs as long as
    its LONGEST member while finished rows idle. Returns the number of
    USEFUL new tokens (each request's own budget; lockstep overshoot is
    discarded). The caller times it."""
    dev = resolve_device(device)
    reqs = sorted(requests, key=lambda r: r.arrival)
    P_max = max(_prompt_len(r) for r in reqs)
    N_max = max(r.max_new_tokens for r in reqs)
    if P_max + N_max > max_len:
        raise ValueError(f"the longest prompt ({P_max}) + the largest "
                         f"budget ({N_max}) exceed max_len={max_len}")
    for g0 in range(0, len(reqs), batch):
        group = reqs[g0:g0 + batch]
        while len(group) < batch:     # pad the tail group by repetition
            group.append(group[-1])
        prompts = np.zeros((batch, P_max), np.int64)
        lens = np.zeros((batch,), np.int64)
        for i, r in enumerate(group):
            p = np.asarray(r.prompt, np.int64)
            prompts[i, P_max - len(p):] = p       # LEFT-padded
            lens[i] = len(p)
        generate(params, cfg, prompts, max_new_tokens=N_max,
                 max_len=max_len, use_kernels=use_kernels,
                 prompt_lens=lens, device=dev)
    return sum(r.max_new_tokens for r in reqs)
