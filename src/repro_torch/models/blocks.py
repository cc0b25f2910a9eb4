"""LayerSpec interpreter (the port of ``repro.models.blocks``): one block
is an optional cross-attention sublayer into a memory (``cross_attn``,
before the mixer, its own pre-norm ``norm_x`` and a plain residual add),
a pre-norm sequence mixer (attention ``mixer="attn"``, sliding-window
``"swa"`` or the Mamba ``"ssm"``) and, where the spec has one, a
feed-forward sublayer: the dense SwiGLU (``ff="dense"``) or the
Mixture-of-Experts (``ff="moe"``, ``models/moe.py``); an ssm block of
falcon-mamba has ``ff="none"``: the mixer is the whole block. A block runs
with no cache (the training forward, optionally rematerialized block by
block) or against its cache in fused-prefill or one-token decode mode. An
MoE block with no cache returns its router's losses (``moe_aux``,
``moe_z``), which the stack sums in layer order; zero without MoE blocks,
as the reference's ``ZERO_AUX``. A block without a router, or against a
cache (prefill and decode drop the losses), adds no operation for them.
An ssm block's cache is
``{"ssm": {"h", "conv"}}``: the f32 state (B, d_inner, d_state) and the
last ``d_conv - 1`` inputs (B, d_conv - 1, d_inner), f32 as in the
reference. A cross block's cache adds the projected memory ``cross_k``/
``cross_v`` (B, memory_len, kv, hd), filled once by
``transformer.build_cross_cache`` and read, unchanged, by prefill and
decode.

The JAX package scans the repeating body over stacked parameters; the port
holds one tree per layer: ``stack["body"][j][i]`` is repeat ``i`` of body
slot ``j`` (``repro_torch.convert.lm_to_torch`` unstacks), and a Python
loop runs the layers in the reference's order.

With kernels on, an MoE block's pre-ff norm runs in the fused residual
norm kernel and its shared expert in the SwiGLU kernel, as a dense block's
do (the reference calls both plainly there; each kernel computes the same
function, and no plain version runs on the card's kernel path).

Tensor parallelism (Megatron): inside
:func:`repro_torch.core.expert_parallel.manual_mode` a block may receive
this rank's slice of its attention projections (q/k/v columns and wo rows
of its heads) or of its dense MLP (w_gate/w_up columns, w_down rows).
:func:`_tp_axis` sees the slice from the leaf's shape, and the sublayer
becomes one partial-sum region: ``region_in`` on everything replicated
that enters it (the normed stream and the qk-norm scales), ``region_out``
(the one sum over the model axis) on its output, in the training forward
and against a cache alike (prefill and decode of a model-sharded engine,
whose cache holds the rank's kv heads). A slice goes through the same
kernels as the whole layer. MoE, SSM and cross blocks take no slice in
serving (``serving.ContinuousEngine`` refuses them on a mesh).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import expert_parallel as EP
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]
Tensor = torch.Tensor


def _tp_axis(local_dim: int, full_dim: int) -> Optional[str]:
    """The model axis when a block inside a manual region holds a
    tensor-parallel slice (its leaf's width ``local_dim`` short of the
    config's ``full_dim``), else None: the same shape test as
    :func:`EP.manual_shard_mode`, so it agrees with the spec builder."""
    st = EP.manual_state()
    if st is None or st.model_axis is None:
        return None
    return st.model_axis if local_dim != full_dim else None


def _sum_aux(acc: Dict[str, Tensor], new: Dict[str, Tensor]
             ) -> Dict[str, Tensor]:
    """``acc + new`` key by key; a key only one of them holds is kept."""
    return {**acc, **{k: acc[k] + v if k in acc else v
                      for k, v in new.items()}}


def _with_zeros(aux: Dict[str, Tensor], device) -> Dict[str, Tensor]:
    """The stack's losses, zero where no block gave one (``ZERO_AUX``)."""
    zero = torch.zeros((), device=device)
    return {"moe_aux": zero, "moe_z": zero, **aux}


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype: torch.dtype) -> Params:
    dev = gen.device
    p: Params = {}
    if spec.mixer in ("attn", "swa"):
        p["norm1"] = L.norm_init(cfg, cfg.d_model, dev)
        p["mixer"] = L.attention_init(gen, cfg, dtype)
    elif spec.mixer == "ssm":
        p["norm1"] = L.norm_init(cfg, cfg.d_model, dev)
        p["mixer"] = SSM.ssm_init(gen, cfg, dtype)
    if spec.cross_attn:
        p["norm_x"] = L.norm_init(cfg, cfg.d_model, dev)
        p["cross"] = L.cross_attention_init(gen, cfg, dtype)
    if spec.ff == "dense":
        p["norm2"] = L.norm_init(cfg, cfg.d_model, dev)
        p["ff"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif spec.ff == "moe":
        p["norm2"] = L.norm_init(cfg, cfg.d_model, dev)
        p["ff"] = MOE.moe_init(gen, cfg, dtype)
    return p


def block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                dtype: torch.dtype, layout: str = "seq", page_size: int = 64,
                total_pages: Optional[int] = None,
                cache_dtype: Optional[str] = None, device=None,
                memory_len: int = 0, kv_heads: Optional[int] = None
                ) -> Params:
    """Decode-time cache of one block: ``layout`` "seq" (B, S, kv, hd),
    "head" (B, kv, S, hd), the decode kernel's layout, or "paged" (page
    pool + block tables; swa layers keep their head-major ring).
    ``cache_dtype="int8"`` quantizes the paged pool per slot (see
    ``layers.init_kv_cache``). A cross block also holds zeroed
    ``cross_k``/``cross_v`` (B, memory_len, kv, hd) in ``dtype``, whatever
    the layout. ``kv_heads`` (default ``cfg.n_kv_heads``) is the
    attention cache's kv heads."""
    c: Params = {}
    if spec.mixer in ("attn", "swa"):
        window = cfg.sliding_window if spec.mixer == "swa" else None
        c["attn"] = L.init_kv_cache(cfg, batch, max_len, window, dtype,
                                    layout=layout, page_size=page_size,
                                    total_pages=total_pages,
                                    cache_dtype=cache_dtype, device=device,
                                    kv_heads=kv_heads)
    elif spec.mixer == "ssm":
        c["ssm"] = SSM.init_ssm_cache(cfg, batch, device=device)
    if spec.cross_attn:
        shape = (batch, memory_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def block_apply(params: Params, cfg: ModelConfig, spec: LayerSpec, x: Tensor,
                *, cache: Optional[Params] = None,
                positions: Optional[Tensor] = None,
                memory: Optional[Tensor] = None,
                pos: Union[int, Tensor, None] = None, decode: bool = False,
                causal: bool = True, use_kernels: bool = False,
                offsets: Optional[Tensor] = None
                ) -> Tuple[Tensor, Optional[Params], Dict[str, Tensor]]:
    """Apply one block. With no cache it is the training forward over
    ``positions``; against a cache, ``decode=True`` is one token at ``pos``
    and otherwise the fused prefill over ``positions`` fills the cache.
    A cross block attends ``memory`` (B, S, D) with no cache, else the
    cache's ``cross_k``/``cross_v``, which it leaves as they are.
    Returns (x, cache, aux), the cache updated in place (None without
    one); aux holds an MoE block's router losses with no cache, else
    nothing (prefill and decode drop them)."""
    aux: Dict[str, Tensor] = {}
    if spec.cross_attn:
        h = L.norm_apply(cfg, params["norm_x"], x, use_kernels=use_kernels)
        if cache is None:
            k, v = L.cross_kv(params["cross"], cfg, memory)
        else:
            k, v = cache["cross_k"], cache["cross_v"]
        x = x + L.cross_attention_apply(params["cross"], cfg, h, k, v)
    y_mix = None
    if spec.mixer in ("attn", "swa"):
        window = cfg.sliding_window if spec.mixer == "swa" else None
        h = L.norm_apply(cfg, params["norm1"], x, use_kernels=use_kernels)
        mp = params["mixer"]
        ax = _tp_axis(mp["wq"].shape[-1], cfg.n_heads * cfg.head_dim)
        if ax is not None:
            # head-split qkv (column-parallel) and wo (row-parallel): one
            # partial-sum region, the per-head qk-norm scales fenced too;
            # a cache holds this rank's kv heads
            mp = dict(mp)
            for nk in ("q_norm", "k_norm"):
                if nk in mp:
                    mp[nk] = {**mp[nk],
                              "scale": EP.region_in(mp[nk]["scale"], ax)}
            h = EP.region_in(h, ax)
        if cache is None:
            y_mix = L.attention_full(mp, cfg, h, positions, window=window,
                                     causal=causal, use_kernels=use_kernels)
        elif decode:
            y_mix, _ = L.attention_decode(mp, cfg, h, cache["attn"], pos,
                                          window=window, offsets=offsets,
                                          use_kernels=use_kernels)
        else:
            y_mix, _ = L.attention_prefill(mp, cfg, h, positions,
                                           cache["attn"], window=window,
                                           offsets=offsets,
                                           use_kernels=use_kernels)
        if ax is not None:
            y_mix = EP.region_out(y_mix, ax)
    elif spec.mixer == "ssm":
        h = L.norm_apply(cfg, params["norm1"], x, use_kernels=use_kernels)
        if cache is None:
            y_mix = SSM.ssm_forward(params["mixer"], cfg, h,
                                    use_kernels=use_kernels)
        else:
            if decode:
                y_mix, sc = SSM.ssm_decode(params["mixer"], cfg, h,
                                           cache["ssm"])
            else:
                valid = None
                if offsets is not None:
                    valid = torch.arange(x.shape[1], device=x.device)[None] \
                        >= offsets[:, None]
                y_mix, sc = SSM.ssm_prefill(params["mixer"], cfg, h,
                                            valid=valid,
                                            use_kernels=use_kernels)
            # in place, cast to the cache's dtypes (a bf16 model's conv
            # state was rounded through bf16 on the way)
            for name, leaf in cache["ssm"].items():
                leaf.copy_(sc[name])
    if spec.ff in ("dense", "moe"):
        # the mixer's residual add fused with the ff pre-norm
        if y_mix is not None:
            h, x = L.norm_residual_apply(cfg, params["norm2"], x, y_mix,
                                         use_kernels=use_kernels)
        else:
            h = L.norm_apply(cfg, params["norm2"], x,
                             use_kernels=use_kernels)
        ax = (_tp_axis(params["ff"]["w_gate"].shape[-1], cfg.d_ff)
              if spec.ff == "dense" else None)
        if ax is not None:
            # column-parallel w_gate/w_up, row-parallel w_down
            x = x + EP.region_out(
                L.mlp_apply(params["ff"], EP.region_in(h, ax),
                            use_kernels=use_kernels), ax)
        elif spec.ff == "dense":
            x = x + L.mlp_apply(params["ff"], h, use_kernels=use_kernels)
        else:
            y, aux = MOE.moe_apply(params["ff"], cfg, h,
                                   use_kernels=use_kernels,
                                   losses=cache is None)
            x = x + y
    elif y_mix is not None:
        x = x + y_mix
    return x, cache, aux


# ---------------------------------------------------------------------------
# stacks: head + body (repeated) + tail
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    return {
        "head": [block_init(gen, cfg, s, dtype) for s in cfg.head_pattern],
        "body": [[block_init(gen, cfg, s, dtype)
                  for _ in range(cfg.body_repeats)]
                 for s in cfg.body_pattern],
        "tail": [block_init(gen, cfg, s, dtype) for s in cfg.tail_pattern],
    }


def stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype, layout: str = "seq", page_size: int = 64,
                total_pages: Optional[int] = None,
                cache_dtype: Optional[str] = None, device=None,
                memory_len: int = 0, kv_heads: Optional[int] = None
                ) -> Params:
    """Caches of every layer (a cross block's ``memory_len`` deep). Under
    ``layout="paged"`` every paged layer holds its own page pool but all
    share ONE block table tensor ``pt`` (the reference keeps one logical
    table and broadcasts it to every layer), so writing the table once
    updates every layer."""
    def one(spec):
        return block_cache(cfg, spec, batch, max_len, dtype, layout,
                           page_size, total_pages, cache_dtype, device,
                           memory_len, kv_heads)

    tree = {
        "head": [one(s) for s in cfg.head_pattern],
        "body": [[one(s) for _ in range(cfg.body_repeats)]
                 for s in cfg.body_pattern],
        "tail": [one(s) for s in cfg.tail_pattern],
    }
    paged = [c["attn"] for _, c in each_layer(tree, cfg)
             if "pt" in c.get("attn", {})]
    for c in paged[1:]:
        c["pt"] = paged[0]["pt"]
    return tree


def each_layer(tree: Params, cfg: ModelConfig
               ) -> List[Tuple[LayerSpec, Any]]:
    """(spec, subtree) of every layer of a parameter or cache tree, in
    execution order."""
    out = list(zip(cfg.head_pattern, tree["head"]))
    for i in range(cfg.body_repeats):
        out += [(s, tree["body"][j][i])
                for j, s in enumerate(cfg.body_pattern)]
    return out + list(zip(cfg.tail_pattern, tree["tail"]))


def stack_apply(params: Params, cfg: ModelConfig, x: Tensor, *,
                cache: Optional[Params] = None,
                positions: Optional[Tensor] = None,
                memory: Optional[Tensor] = None,
                pos: Union[int, Tensor, None] = None, decode: bool = False,
                causal: bool = True, use_kernels: bool = False,
                remat: bool = False,
                offsets: Optional[Tensor] = None
                ) -> Tuple[Tensor, Optional[Params], Dict[str, Tensor]]:
    """Run head + body + tail: with no cache, the training forward over
    ``positions``; otherwise against ``cache`` (updated in place). Returns
    (x, cache, aux): with no cache the blocks' auxiliary losses summed in
    layer order (zero without MoE blocks), against a cache an empty dict
    (prefill and decode drop the losses).

    ``memory`` (B, S, D) is what the cross blocks attend with no cache.
    ``remat=True`` (no cache) recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of the
    reference's ``jax.checkpoint(nothing_saveable)``: only each block's
    inputs stay alive between the passes (the memory is one of them, so
    its gradient reaches the encoder); a checkpointed block returns its
    output and its aux losses."""
    if cache is None:
        aux: Dict[str, Tensor] = {}
        for spec, p in each_layer(params, cfg):
            def fn(xb, mem, p=p, spec=spec):
                xo, _, a = block_apply(p, cfg, spec, xb, positions=positions,
                                       memory=mem, causal=causal,
                                       use_kernels=use_kernels)
                return xo, a
            x, a = (checkpoint(fn, x, memory, use_reentrant=False) if remat
                    else fn(x, memory))
            aux = _sum_aux(aux, a)
        return x, None, _with_zeros(aux, x.device)
    for (spec, p), (_, c) in zip(each_layer(params, cfg),
                                 each_layer(cache, cfg)):
        x, _, _ = block_apply(p, cfg, spec, x, cache=c, positions=positions,
                              pos=pos, decode=decode,
                              use_kernels=use_kernels, offsets=offsets)
    return x, cache, {}
