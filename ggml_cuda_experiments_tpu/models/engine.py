"""Serving engine: continuous batching over a paged (optionally INT8) KV
cache.

The scheduler lives OUTSIDE the jit boundary (SURVEY §7 "hard parts"):
admission, page allocation, and completion are host-side Python over numpy
state; the device work is two jitted, fixed-shape functions (per-request
paged prefill, batched paged decode). Requests join and leave the running
batch between steps — continuous batching — while the KV pool pages are
recycled through a free list.

Page accounting is conservative (vLLM's "no-preemption" mode): a request is
admitted only if pages for its full prompt+max_new_tokens fit, so decode
never fails allocation mid-flight.

No reference analog (the CUDA repo is single-kernel harnesses); mandated by
BASELINE.json configs 4-5.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.models import llama
from ggml_cuda_experiments_tpu.models.sampling import SamplingParams, sample
from ggml_cuda_experiments_tpu.ops.paged_attention import paged_decode
from ggml_cuda_experiments_tpu.ops.attention import attention

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVPool:
    """Shared page pool: k/v [L, n_pages, Hkv, ps, D] (+ scales if int8)."""
    k: jax.Array
    v: jax.Array
    k_scale: jax.Array | None = None
    v_scale: jax.Array | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def quant_fmt(self) -> str | None:
        if not self.quantized:
            return None
        return "int8" if self.k.dtype == jnp.int8 else "fp8"

    @staticmethod
    def create(cfg: ModelConfig, n_pages: int, page_size: int,
               quantized: bool | str = False, dtype=jnp.bfloat16
               ) -> "PagedKVPool":
        """``quantized``: False, True/"int8", or "fp8" (float8_e4m3)."""
        # page-major across heads (see ops/paged_attention.py)
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                 cfg.head_dim)
        if quantized:
            qdt = jnp.float8_e4m3fn if quantized == "fp8" else jnp.int8
            return PagedKVPool(
                k=jnp.zeros(shape, qdt), v=jnp.zeros(shape, qdt),
                k_scale=jnp.zeros(shape[:-1], jnp.float32),
                v_scale=jnp.zeros(shape[:-1], jnp.float32))
        return PagedKVPool(k=jnp.zeros(shape, dtype),
                           v=jnp.zeros(shape, dtype))


# ---------------------------------------------------------------------------
# jitted device steps
# ---------------------------------------------------------------------------

def _rope_one(x, positions, theta):
    return llama.rope(x, positions, theta)


def _paged_prefill(params: Params, cfg: ModelConfig, tokens: jax.Array,
                   length: jax.Array, page_row: jax.Array, pool: PagedKVPool,
                   reduce_axis: str | None = None
                   ) -> tuple[jax.Array, PagedKVPool]:
    """Prefill ONE request: tokens [1, T] (T = padded prompt), length scalar
    (true prompt length), page_row [pages_per_seq]. Returns last-valid-token
    logits [1, V] and the pool with the prompt's KV written.

    Padded-tail tokens (t >= length) are routed to the reserved trash page
    (the pool's last page, never allocated) so they cannot corrupt another
    sequence's pages.

    ``reduce_axis``: shard_map axis name for tensor parallelism (cfg then
    describes the local shard; one psum after wo and one after w_down, the
    Megatron row-parallel contractions — see parallel/tp.py)."""
    B, T = tokens.shape
    ps = pool.k.shape[3]
    trash = pool.k.shape[1] - 1
    h = params["embed"][tokens]
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    t_idx = jnp.arange(T, dtype=jnp.int32)
    # one page index per WHOLE-PAGE run of the (page-aligned) prompt
    # window; fully-invalid runs route to the trash page (partially
    # valid runs write their own page's unread tail — harmless)
    n_runs = -(-T // ps)
    run_starts = jnp.arange(n_runs, dtype=jnp.int32) * ps
    run_pages = jnp.where(
        run_starts < length,
        page_row[jnp.minimum(run_starts // ps, page_row.shape[0] - 1)],
        trash)

    # running FULL pool arrays: per-(layer, token) scatters into the donated
    # 5-D arrays alias in place; a per-layer slice + end-of-step jnp.stack
    # would copy the entire pool every call (pool.k[li, :, pages[t], offs[t]]
    # writes a [T, Hkv, ...]-shaped update — advanced dims lead because the
    # head slice separates them)
    pk, pv = pool.k, pool.v
    pks, pvs = pool.k_scale, pool.v_scale
    for li, layer in enumerate(params["layers"]):
        x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        q, k, v = llama.qkv_proj(layer, x, cfg)
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        q = _rope_one(q, positions, cfg.rope_theta)
        k = _rope_one(k, positions, cfg.rope_theta)
        kt = k.transpose(0, 2, 1, 3)[0]          # [Hkv, T, D]
        vt = v.transpose(0, 2, 1, 3)[0]

        if pool.quantized:
            kq, ksc = llama._quantize_rowwise(kt, pool.quant_fmt)
            vq, vsc = llama._quantize_rowwise(vt, pool.quant_fmt)
            pk = _pool_write_pages(pk, li, run_pages, kq, ps)
            pv = _pool_write_pages(pv, li, run_pages, vq, ps)
            pks = _pool_write_pages_scale(pks, li, run_pages, ksc, ps)
            pvs = _pool_write_pages_scale(pvs, li, run_pages, vsc, ps)
        else:
            pk = _pool_write_pages(pk, li, run_pages, kt, ps)
            pv = _pool_write_pages(pv, li, run_pages, vt, ps)

        # attention over the fresh bf16 K/V; padded tail masked causally +
        # by length
        o = attention(
            q.transpose(0, 2, 1, 3), kt[None], vt[None], causal=True,
            kv_lengths=jnp.reshape(length, (1,)),
            impl=None if cfg.impl is None else "xla",
        ).transpose(0, 2, 1, 3)
        o = o.reshape(B, T, cfg.n_heads * cfg.head_dim).astype(h.dtype)
        attn = llama.apply_linear(o, layer["wo"], impl=cfg.impl)
        if reduce_axis is not None:
            attn = jax.lax.psum(attn, reduce_axis)
        h = h + attn
        h = h + llama._mlp_block(layer, cfg, h, reduce_axis=reduce_axis)

    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    last = h[jnp.arange(B), length - 1]          # [B, dim] at true last token
    logits = llama.apply_linear(last, params["lm_head"],
                                impl=cfg.impl).astype(jnp.float32)

    new_pool = PagedKVPool(k=pk, v=pv, k_scale=pks, v_scale=pvs)
    return logits, new_pool


paged_prefill = functools.partial(jax.jit, static_argnames=("cfg",),
                                  donate_argnames=("pool",))(_paged_prefill)


def _paged_prefill_chunk(params: Params, cfg: ModelConfig,
                         tokens: jax.Array, pos0: jax.Array,
                         length: jax.Array, page_row: jax.Array,
                         pool: PagedKVPool, *, with_logits: bool = False
                         ) -> tuple[jax.Array | None, PagedKVPool]:
    """Chunked prefill: forward ONE fixed-size window of a prompt against
    the page pool. tokens [1, C] are the prompt slice [pos0, pos0+C) (tail
    padded past ``length``); previous chunks' KV is read back from the pool
    (gather over ``page_row``), so a long prompt is processed in C-token
    steps interleaved with decode — one admitted prompt can no longer
    stall every running request's decode for its full length.

    The gather (pages -> contiguous [Hkv, S, D]) is XLA-fused into the
    dequant + attention operands; its bytes are 1/C of the chunk's
    attention traffic. Returns (last-valid-position logits if
    ``with_logits`` else None, pool with the window written).
    """
    B, C = tokens.shape
    ps = pool.k.shape[3]
    trash = pool.k.shape[1] - 1
    P = page_row.shape[0]
    S = P * ps
    h = params["embed"][tokens]
    t_glob = pos0 + jnp.arange(C, dtype=jnp.int32)           # [C]
    positions = jnp.broadcast_to(t_glob, (B, C))
    # page-run DUS writes (see _pool_write): needs runs that never
    # straddle a page — Engine enforces C % ps == 0 or ps % C == 0, and
    # pos0 is always a multiple of C
    if C % ps == 0:
        n_runs, run_len = C // ps, ps
    else:
        n_runs, run_len = 1, C
    run_starts = pos0 + jnp.arange(n_runs, dtype=jnp.int32) * run_len
    run_pages = jnp.where(
        run_starts < length,
        page_row[jnp.minimum(run_starts // ps, page_row.shape[0] - 1)],
        trash)
    run_offs = run_starts % ps

    kv_pos = jnp.arange(S, dtype=jnp.int32)[None, None, None, :]
    q_pos = t_glob[None, None, :, None]
    mask = jnp.where(
        (kv_pos <= q_pos) & (kv_pos < length), 0.0, -jnp.inf
    ).astype(jnp.float32)                                    # [1,1,C,S]

    pk, pv = pool.k, pool.v
    pks, pvs = pool.k_scale, pool.v_scale
    for li, layer in enumerate(params["layers"]):
        x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        q, k, v = llama.qkv_proj(layer, x, cfg)
        q = q.reshape(B, C, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, C, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, C, cfg.n_kv_heads, cfg.head_dim)
        q = _rope_one(q, positions, cfg.rope_theta)
        k = _rope_one(k, positions, cfg.rope_theta)
        kt = k.transpose(0, 2, 1, 3)[0]                      # [Hkv, C, D]
        vt = v.transpose(0, 2, 1, 3)[0]

        if pool.quantized:
            kq, ksc = llama._quantize_rowwise(kt, pool.quant_fmt)
            vq, vsc = llama._quantize_rowwise(vt, pool.quant_fmt)
            pk = _pool_write_pages(pk, li, run_pages, kq, run_len,
                                   run_offs)
            pv = _pool_write_pages(pv, li, run_pages, vq, run_len,
                                   run_offs)
            pks = _pool_write_pages_scale(pks, li, run_pages, ksc,
                                          run_len, run_offs)
            pvs = _pool_write_pages_scale(pvs, li, run_pages, vsc,
                                          run_len, run_offs)
            kg = jnp.take(pk[li], page_row, axis=0).astype(jnp.float32)
            vg = jnp.take(pv[li], page_row, axis=0).astype(jnp.float32)
            ksg = jnp.take(pks[li], page_row, axis=0)
            vsg = jnp.take(pvs[li], page_row, axis=0)
            kseq = (kg * ksg[..., None]).transpose(1, 0, 2, 3).reshape(
                1, cfg.n_kv_heads, S, cfg.head_dim).astype(jnp.bfloat16)
            vseq = (vg * vsg[..., None]).transpose(1, 0, 2, 3).reshape(
                1, cfg.n_kv_heads, S, cfg.head_dim).astype(jnp.bfloat16)
        else:
            pk = _pool_write_pages(pk, li, run_pages, kt, run_len,
                                   run_offs)
            pv = _pool_write_pages(pv, li, run_pages, vt, run_len,
                                   run_offs)
            kseq = jnp.take(pk[li], page_row, axis=0).transpose(
                1, 0, 2, 3).reshape(1, cfg.n_kv_heads, S, cfg.head_dim)
            vseq = jnp.take(pv[li], page_row, axis=0).transpose(
                1, 0, 2, 3).reshape(1, cfg.n_kv_heads, S, cfg.head_dim)

        o = attention(
            q.transpose(0, 2, 1, 3).astype(kseq.dtype), kseq, vseq, mask,
        ).transpose(0, 2, 1, 3)
        o = o.reshape(B, C, cfg.n_heads * cfg.head_dim).astype(h.dtype)
        h = h + llama.apply_linear(o, layer["wo"], impl=cfg.impl)
        h = h + llama._mlp_block(layer, cfg, h)

    if not with_logits:
        return None, PagedKVPool(k=pk, v=pv, k_scale=pks, v_scale=pvs)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    last = h[jnp.arange(B), length - 1 - pos0]
    logits = llama.apply_linear(last, params["lm_head"],
                                impl=cfg.impl).astype(jnp.float32)
    return logits, PagedKVPool(k=pk, v=pv, k_scale=pks, v_scale=pvs)


paged_prefill_chunk = functools.partial(
    jax.jit, static_argnames=("cfg", "with_logits"),
    donate_argnames=("pool",))(_paged_prefill_chunk)


def _pool_write(pool5, li, pages_b, offs_b, val):
    """val [B, Hkv, D] -> pool [L, n_pages, Hkv, ps, D] at
    (li, pages_b[b], :, offs_b[b]) via per-sequence dynamic_update_slice
    (in-place under donation; see the scatter note at the call site)."""
    B = val.shape[0]
    for b in range(B):
        upd = val[b][None, None, :, None, :].astype(pool5.dtype)
        pool5 = jax.lax.dynamic_update_slice(
            pool5, upd, (li, pages_b[b], 0, offs_b[b], 0))
    return pool5


def _pool_write_scale(pool4, li, pages_b, offs_b, val):
    """val [B, Hkv] -> scale pool [L, n_pages, Hkv, ps]."""
    B = val.shape[0]
    for b in range(B):
        upd = val[b][None, None, :, None].astype(pool4.dtype)
        pool4 = jax.lax.dynamic_update_slice(
            pool4, upd, (li, pages_b[b], 0, offs_b[b]))
    return pool4


def _pool_write_pages(pool5, li, run_pages, val, run_len, run_offs=None):
    """Prefill writes: val [Hkv, T, D] split into page-aligned runs, one
    dynamic_update_slice per LOGICAL page run (token runs within a page
    are contiguous). Same scatter-copy avoidance as _pool_write; a run
    that extends past the valid length writes its owner page's unread
    tail, which is harmless (run_pages routes fully-invalid runs to
    trash). ``run_offs``: traced within-page start offset per run (the
    chunked-prefill case), default 0."""
    T = val.shape[1]
    for pi in range(-(-T // run_len)):
        run = min(run_len, T - pi * run_len)
        off = 0 if run_offs is None else run_offs[pi]
        upd = val[:, pi * run_len:pi * run_len + run][None, None]
        pool5 = jax.lax.dynamic_update_slice(
            pool5, upd.astype(pool5.dtype), (li, run_pages[pi], 0, off, 0))
    return pool5


def _pool_write_pages_scale(pool4, li, run_pages, val, run_len,
                            run_offs=None):
    """val [Hkv, T] -> scale pool, one DUS per logical page run."""
    T = val.shape[1]
    for pi in range(-(-T // run_len)):
        run = min(run_len, T - pi * run_len)
        off = 0 if run_offs is None else run_offs[pi]
        upd = val[:, pi * run_len:pi * run_len + run][None, None]
        pool4 = jax.lax.dynamic_update_slice(
            pool4, upd.astype(pool4.dtype), (li, run_pages[pi], 0, off))
    return pool4


def _paged_decode_step(params: Params, cfg: ModelConfig, tokens: jax.Array,
                       lengths: jax.Array, page_indices: jax.Array,
                       pool: PagedKVPool, active: jax.Array,
                       reduce_axis: str | None = None
                       ) -> tuple[jax.Array, PagedKVPool]:
    """One decode step for the whole running batch.

    tokens [B] last sampled token per slot; lengths [B] current lengths
    (BEFORE this token); page_indices [B, pages_per_seq]. Inactive slots
    must have lengths >= 1 and valid page rows (their logits are ignored).
    Returns logits [B, V] and the pool including this token's KV.
    """
    B = tokens.shape[0]
    ps = pool.k.shape[3]
    trash = pool.k.shape[1] - 1
    h = params["embed"][tokens[:, None]]                   # [B, 1, dim]
    positions = lengths[:, None]

    pages_b = jnp.take_along_axis(
        page_indices, (lengths // ps)[:, None], axis=1)[:, 0]   # [B]
    pages_b = jnp.where(active, pages_b, trash)   # idle slots -> trash page
    offs_b = lengths % ps

    # running FULL pool arrays (see _paged_prefill): tiny scatters alias in
    # place under donation, and the layer-indexed paged_decode consumes the
    # full 5-D pool (a per-layer slice operand would copy the whole layer's
    # pool — ~67 MB per layer at 7B-serving pool sizes — every step)
    pk, pv = pool.k, pool.v
    pks, pvs = pool.k_scale, pool.v_scale
    for li, layer in enumerate(params["layers"]):
        x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        q, k, v = llama.qkv_proj(layer, x, cfg)
        q = q.reshape(B, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        q = _rope_one(q[:, None], positions, cfg.rope_theta)[:, 0]
        k = _rope_one(k, positions, cfg.rope_theta)
        kt = k[:, 0]                                       # [B, Hkv, D]
        vt = v[:, 0]

        # scatter the batch's new tokens: index arrays are [B]; the update
        # value is [B, Hkv, D] (advanced dims lead across the head slice)
        if pool.quantized:
            kq, ksc = llama._quantize_rowwise(kt, pool.quant_fmt)
            vq, vsc = llama._quantize_rowwise(vt, pool.quant_fmt)
            # per-sequence dynamic_update_slice, NOT an advanced-index
            # scatter: a scatter into the ~GB pool is not done in place
            # by XLA here and copies the whole array per layer (measured:
            # paged decode step time scaled linearly with pool bytes);
            # tiny DUS writes alias under donation like the contiguous
            # cache's _write_cache_layer
            pk = _pool_write(pk, li, pages_b, offs_b, kq)
            pv = _pool_write(pv, li, pages_b, offs_b, vq)
            pks = _pool_write_scale(pks, li, pages_b, offs_b, ksc)
            pvs = _pool_write_scale(pvs, li, pages_b, offs_b, vsc)
            o = paged_decode(
                q, pk, pv, lengths + 1, page_indices,
                k_scale_pages=pks, v_scale_pages=pvs, layer=li,
                impl=cfg.impl)
        else:
            pk = _pool_write(pk, li, pages_b, offs_b, kt)
            pv = _pool_write(pv, li, pages_b, offs_b, vt)
            o = paged_decode(q, pk, pv, lengths + 1, page_indices,
                             layer=li, impl=cfg.impl)

        o = o.reshape(B, 1, cfg.n_heads * cfg.head_dim).astype(h.dtype)
        attn = llama.apply_linear(o, layer["wo"], impl=cfg.impl)
        if reduce_axis is not None:
            attn = jax.lax.psum(attn, reduce_axis)
        h = h + attn
        h = h + llama._mlp_block(layer, cfg, h, reduce_axis=reduce_axis)

    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h[:, 0], params["lm_head"],
                                impl=cfg.impl).astype(jnp.float32)
    new_pool = PagedKVPool(k=pk, v=pv, k_scale=pks, v_scale=pvs)
    return logits, new_pool


paged_decode_step = functools.partial(
    jax.jit, static_argnames=("cfg",),
    donate_argnames=("pool",))(_paged_decode_step)


def _paged_decode_window(params: Params, cfg: ModelConfig, tokens: jax.Array,
                         lengths: jax.Array, page_indices: jax.Array,
                         pool: PagedKVPool, active: jax.Array,
                         key: jax.Array, sampling: SamplingParams,
                         steps: int,
                         reduce_axis: str | None = None):
    """``steps`` decode iterations in ONE dispatch (lax.scan): the
    scheduler only needs to intervene when a request finishes, so between
    scheduler passes the whole window runs on-device, amortizing per-call
    dispatch. The caller sizes the window so no running request can finish
    inside it. Returns (tokens [steps, B], final tokens [B], final lengths
    [B], pool); lengths advance ACTIVE slots only, so the returned array
    can serve as the next window's input directly (the engine keeps it on
    device instead of re-uploading lengths/page_table/active per pass)."""
    adv = active.astype(jnp.int32)

    def body(carry, w):
        toks, lens, pool = carry
        logits, pool = _paged_decode_step(
            params, cfg, toks, lens, page_indices, pool, active,
            reduce_axis=reduce_axis)
        nxt = sample(logits, jax.random.fold_in(key, w), sampling)
        nxt = nxt.astype(jnp.int32)
        return (nxt, lens + adv, pool), nxt

    (last, lens_out, pool), trace = jax.lax.scan(
        body, (tokens, lengths, pool), jnp.arange(steps, dtype=jnp.int32))
    return trace, last, lens_out, pool


paged_decode_window = functools.partial(
    jax.jit, static_argnames=("cfg", "sampling", "steps"),
    donate_argnames=("pool",))(_paged_decode_window)


# ---------------------------------------------------------------------------
# tensor-parallel wrappers (BASELINE config 4: engine over a model mesh)
# ---------------------------------------------------------------------------

def _pool_specs(pool: PagedKVPool):
    """PartitionSpec tree for the pool: KV heads on the ``model`` axis
    (dim 2 of [L, n_pages, Hkv, ps, D]) — GQA co-location keeps paged
    attention communication-free, exactly as for the contiguous cache
    (parallel/tp.py)."""
    from jax.sharding import PartitionSpec as P
    s5 = P(None, None, "model", None, None)
    s4 = P(None, None, "model", None)
    return PagedKVPool(
        k=s5, v=s5,
        k_scale=None if pool.k_scale is None else s4,
        v_scale=None if pool.v_scale is None else s4,
    )


def make_tp_engine_steps(cfg: ModelConfig, mesh, params: Params,
                         pool: PagedKVPool):
    """Build shard_map-ed (prefill, decode) steps for a tensor-parallel
    engine. ``params`` must already be TP-sharded (parallel/tp.py:
    quantize_params_sharded + shard_params); cfg is the GLOBAL config.
    Logits come back vocab-sharded and are reassembled by the out spec."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from ggml_cuda_experiments_tpu.parallel import tp

    lcfg = tp.local_config(cfg, mesh.shape["model"])
    pspecs = tp.param_specs(params)
    kvspecs = _pool_specs(pool)
    rep = P()

    def prefill(params, tokens, length, page_row, pool):
        return _paged_prefill(params, lcfg, tokens, length, page_row, pool,
                              reduce_axis="model")

    def decode(params, tokens, lengths, page_indices, pool, active):
        return _paged_decode_step(params, lcfg, tokens, lengths,
                                  page_indices, pool, active,
                                  reduce_axis="model")

    prefill_s = jax.jit(shard_map(
        prefill, mesh=mesh,
        in_specs=(pspecs, rep, rep, rep, kvspecs),
        out_specs=(P(None, "model"), kvspecs),
        check_vma=False,
    ), donate_argnums=(4,))

    decode_s = jax.jit(shard_map(
        decode, mesh=mesh,
        in_specs=(pspecs, rep, rep, rep, kvspecs, rep),
        out_specs=(P(None, "model"), kvspecs),
        check_vma=False,
    ), donate_argnums=(4,))

    return prefill_s, decode_s


# ---------------------------------------------------------------------------
# host-side scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    pages: list[int] | None = None
    done: bool = False
    # deferred-fetch bookkeeping (token VALUES stay on device)
    n_generated: int = 0
    first_dev: Any = None
    start_step: int = 0
    # chunked prefill progress (tokens of the prompt already processed)
    prefill_pos: int = 0

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)


class PageAllocator:
    def __init__(self, n_pages: int):
        self.free = list(range(n_pages))

    def alloc(self, n: int) -> list[int] | None:
        if len(self.free) < n:
            return None
        out, self.free = self.free[:n], self.free[n:]
        return out

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)


class Engine:
    """Continuous-batching inference engine (single host)."""

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 max_batch: int = 8, page_size: int = 64,
                 n_pages: int = 256, max_seq_len: int | None = None,
                 quantized_kv: bool = False, eos_id: int | None = None,
                 sampling: SamplingParams | None = None, seed: int = 0,
                 scheduler: str = "python", mesh=None,
                 decode_window: int = 1, prefill_chunk: int | None = None):
        self.params = params
        self.cfg = cfg
        # default greedy (temperature 0); per-step PRNG folds the step count
        self.sampling = sampling or SamplingParams(temperature=0.0)
        self._key = jax.random.PRNGKey(seed)
        self._step_no = 0
        assert scheduler in ("python", "native")
        self._nsched = None
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.pages_per_seq = -(-self.max_seq_len // page_size)
        self.pool = PagedKVPool.create(cfg, n_pages, page_size,
                                       quantized=quantized_kv)
        # last page is the reserved trash page (padding / idle-slot writes)
        self.trash_page = n_pages - 1
        self.allocator = PageAllocator(n_pages - 1)
        if scheduler == "native":
            from ggml_cuda_experiments_tpu.utils import native_sched
            assert native_sched.available(), (
                "native scheduler requested but libgct_native.so not "
                "built (make -C native)")
            self._nsched = native_sched.NativeScheduler(
                max_batch, n_pages - 1, self.pages_per_seq, page_size,
                self.max_seq_len)
        self.eos_id = eos_id

        # device step functions: plain jitted, or shard_map'd over a
        # tensor-parallel mesh (params must then be TP-sharded, see
        # parallel/tp.py; the pool is re-placed KV-head-sharded here)
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding
            kvspecs = _pool_specs(self.pool)
            self.pool = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                self.pool, kvspecs)
            prefill_s, decode_s = make_tp_engine_steps(
                cfg, mesh, params, self.pool)
            self._prefill_fn = lambda *a: prefill_s(self.params, *a)
            self._decode_fn = lambda *a: decode_s(self.params, *a)
        else:
            self._prefill_fn = lambda *a: paged_prefill(
                self.params, self.cfg, *a)
            self._decode_fn = lambda *a: paged_decode_step(
                self.params, self.cfg, *a)

        # Chunked prefill: prompts longer than ``prefill_chunk`` are
        # processed one fixed-size chunk per scheduler step, interleaved
        # with the running batch's decode steps — a long prompt cannot
        # stall decodes for its full length.
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            assert scheduler == "python", \
                "prefill_chunk needs the python scheduler"
            assert mesh is None, "prefill_chunk not yet supported with TP"
            assert (prefill_chunk % page_size == 0
                    or page_size % prefill_chunk == 0), (
                "prefill_chunk must divide or be a multiple of page_size "
                "(page-run DUS writes must not straddle pages)")

        self.waiting: list[Request] = []
        self.prefilling: list[Request] = []
        self.running: list[Request] = []
        self._next_rid = 0
        # fixed-shape device-side slot state
        self.slot_req: list[Request | None] = [None] * max_batch
        self.lengths = np.ones((max_batch,), np.int32)
        self.tokens = np.zeros((max_batch,), np.int32)
        self.page_table = np.full((max_batch, self.pages_per_seq),
                                  self.trash_page, np.int32)

        # Deferred-fetch mode (no EOS scanning needed): sampled tokens stay
        # ON DEVICE and feed the next step directly; the host never blocks
        # on logits. Values are fetched ONCE per request at completion
        # (completion is decided by counts alone when eos_id is None), so
        # no per-step device->host sync sits on the dispatch path.
        self._defer = eos_id is None
        self._tokens_dev = jnp.zeros((max_batch,), jnp.int32)
        self._trace: list[jax.Array] = []      # per-step [max_batch] tokens
        # Device mirror of (lengths, page_table, active): in steady-state
        # windowed decode NOTHING about them changes host-side between
        # scheduler passes (the window advances lengths on device and
        # returns them), so re-uploading all three every pass puts
        # host->device transfers on the dispatch path for no reason.
        # Invalidate on any host mutation (admit / finish-prefill /
        # release / non-window host increments).
        self._dev_state = None

        # Multi-step decode window: run up to ``decode_window`` decode
        # iterations in ONE dispatch (lax.scan), sized each scheduler pass
        # so no running request can finish inside the window. Requires the
        # deferred-fetch mode (eos scanning would need per-token values).
        self.decode_window = decode_window
        if decode_window > 1:
            assert self._defer, "decode_window needs eos_id=None"
            assert self._nsched is None, \
                "decode_window not supported with the native scheduler"
            assert mesh is None, \
                "decode_window not yet supported with a mesh"

    # -- API ---------------------------------------------------------------

    def add_request(self, prompt: list[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, list(prompt), max_new_tokens))
        if self._nsched is not None:
            self._nsched.add_request(rid, len(prompt), max_new_tokens)
        return rid

    def step(self) -> dict[int, list[int]]:
        """Admit + decode one token for every running request.
        Returns {rid: generated_tokens} for requests finishing this step."""
        self._admit()
        finished: dict[int, list[int]] = {}
        if self.prefilling:
            # Dispatch EVERY prefilling request's next chunk before the
            # decode window is dispatched/fetched: dispatches are async,
            # while a chunk deferred to the next scheduler pass waits out
            # a whole decode window + any finished-request fetch. Chunks
            # of ONE request stay serial on device (same pool), but chunks
            # of DIFFERENT requests pipeline behind the window.
            for req in list(self.prefilling):
                self._prefill_step(req)
        if not self.running:
            return finished

        # prefilling slots hold pages but must not decode yet
        active = np.array([r is not None and r in self.running
                           for r in self.slot_req])

        if self._defer:
            # window size: the largest number of steps no running request
            # can complete within (so the scheduler can't miss a finish).
            # ONLY two sizes ever run — the full window or a single step —
            # because every distinct W is a separate compile (a shrink
            # ladder would compile at the end of every generation). Tail
            # steps run singly: under deferred fetch they pipeline without
            # blocking, so the tail costs device time only.
            W = 1
            if self.decode_window > 1:
                room = min(min(r.max_new_tokens - r.n_generated,
                               self.max_seq_len - len(r.prompt)
                               - r.n_generated) for r in self.running)
                W = self.decode_window if room >= self.decode_window else 1
            if self._dev_state is None:
                self._dev_state = (jnp.asarray(self.lengths),
                                   jnp.asarray(self.page_table),
                                   jnp.asarray(active))
            lens_dev, pt_dev, act_dev = self._dev_state
            if W > 1:
                self._step_no += W
                key = jax.random.fold_in(self._key, self._step_no)
                trace_w, last, lens_out, self.pool = paged_decode_window(
                    self.params, self.cfg, self._tokens_dev,
                    lens_dev, pt_dev,
                    self.pool, act_dev, key, self.sampling,
                    steps=W)
                nxt_dev = last
                rows = [trace_w[w] for w in range(W)]
                # window advanced active slots on device; host mirror does
                # the same below — the cache stays valid with zero uploads
                self._dev_state = (lens_out, pt_dev, act_dev)
            else:
                logits, self.pool = self._decode_fn(
                    self._tokens_dev, lens_dev, pt_dev,
                    self.pool, act_dev)
                nxt_dev = self._sample(logits).astype(jnp.int32)
                rows = [nxt_dev]
                # single step advances lengths host-side only
                self._dev_state = None
            # Readiness barrier (NOT a transfer): the XLA CPU backend was
            # observed (~1/15 runs) to corrupt the pending sample when a
            # later step ran with a donated pool — waiting for the sampled
            # tokens (deterministic 0/25 with, 6/25 without) keeps CPU
            # correct. CPU only: on the GPU a wait per scheduler pass
            # would stall dispatch, and chip_smoke.py's serving phase
            # checks the engine's tokens there without it.
            if jax.default_backend() == "cpu":
                jax.block_until_ready(nxt_dev)
            self._tokens_dev = nxt_dev
            self._trace.extend(rows)
            hit = np.zeros((self.max_batch,), np.uint8)
            done_slots = []
            for req in list(self.running):
                s = req.slot
                self.lengths[s] += W
                req.n_generated += W
                if (req.n_generated >= req.max_new_tokens
                        or len(req.prompt) + req.n_generated
                        >= self.max_seq_len):
                    done_slots.append((req.rid, s))
            if self._nsched is not None:
                done_slots = self._nsched.step_complete(hit)
            if done_slots:
                # ONE host fetch for every request finishing this pass
                # (a per-request np.asarray is one sync each)
                reqs = []
                for rid, slot in done_slots:
                    req = self.slot_req[slot]
                    assert req is not None and req.rid == rid
                    reqs.append(req)
                devs = [self._collect_device(r) for r in reqs]
                sizes = np.cumsum([int(d.shape[0]) for d in devs])[:-1]
                flat = np.asarray(jnp.concatenate(devs)) if devs else None
                for req, vals in zip(reqs, np.split(flat, sizes)):
                    finished[req.rid] = [int(t) for t in vals]
                    self._release(req)
            if not self.running:
                self._trace.clear()
            return finished

        logits, self.pool = self._decode_fn(
            jnp.asarray(self.tokens),
            jnp.asarray(self.lengths), jnp.asarray(self.page_table),
            self.pool, jnp.asarray(active))
        next_tokens = np.asarray(self._sample(logits)).astype(np.int32)

        if self._nsched is not None:
            # completion decisions from the native scheduler
            hit = np.zeros((self.max_batch,), np.uint8)
            for req in self.running:
                s = req.slot
                self.lengths[s] += 1
                tok = int(next_tokens[s])
                req.generated.append(tok)
                self.tokens[s] = tok
                if self.eos_id is not None and tok == self.eos_id:
                    hit[s] = 1
            for rid, slot in self._nsched.step_complete(hit):
                req = self.slot_req[slot]
                assert req is not None and req.rid == rid
                finished[rid] = list(req.generated)
                self._release(req)
            return finished

        for req in list(self.running):
            s = req.slot
            self.lengths[s] += 1
            tok = int(next_tokens[s])
            req.generated.append(tok)
            self.tokens[s] = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if (hit_eos or len(req.generated) >= req.max_new_tokens
                    or req.length >= self.max_seq_len):
                finished[req.rid] = list(req.generated)
                self._release(req)
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for _ in range(max_steps):
            out.update(self.step())
            if not self.waiting and not self.running and not self.prefilling:
                break
        return out

    # -- internals ---------------------------------------------------------

    def _admit(self) -> None:
        if self.waiting:
            self._dev_state = None      # page_table/active about to change
        if self._nsched is not None:
            for rid, slot, row in self._nsched.admit():
                req = next(r for r in self.waiting if r.rid == rid)
                self.waiting.remove(req)
                req.slot = slot
                req.pages = [int(p) for p in row if p != self.trash_page]
                self.slot_req[slot] = req
                self.running.append(req)
                self.page_table[slot] = row.astype(np.int32)
                self._prefill_slot(req, slot, self.page_table[slot])
            return
        while (self.waiting and
               len(self.running) + len(self.prefilling) < self.max_batch):
            req = self.waiting[0]
            need = -(-min(len(req.prompt) + req.max_new_tokens,
                          self.max_seq_len) // self.page_size)
            pages = self.allocator.alloc(need)
            if pages is None:
                break
            self.waiting.pop(0)
            slot = self.slot_req.index(None)
            req.slot, req.pages = slot, pages
            self.slot_req[slot] = req
            row = np.full((self.pages_per_seq,), self.trash_page, np.int32)
            row[:len(pages)] = pages
            self.page_table[slot] = row
            if (self.prefill_chunk is not None
                    and len(req.prompt) > self.prefill_chunk):
                self.prefilling.append(req)   # chunked, via _prefill_step
            else:
                self.running.append(req)
                self._prefill_slot(req, slot, row)

    def _prefill_slot(self, req: Request, slot: int, row: np.ndarray
                      ) -> None:
        """Prefill (T padded to a flash block multiple) + first token."""
        T = max(16, 1 << (len(req.prompt) - 1).bit_length())
        toks = np.zeros((1, T), np.int32)
        toks[0, :len(req.prompt)] = req.prompt
        logits, self.pool = self._prefill_fn(
            jnp.asarray(toks),
            jnp.asarray(len(req.prompt), jnp.int32),
            jnp.asarray(row), self.pool)
        self._finish_prefill(req, logits)

    def _prefill_step(self, req: Request | None = None) -> None:
        """Process the next chunk of one prefilling request (oldest by
        default)."""
        if req is None:
            req = self.prefilling[0]
        C = self.prefill_chunk
        pos0 = req.prefill_pos
        last = pos0 + C >= len(req.prompt)
        toks = np.zeros((1, C), np.int32)
        sl = req.prompt[pos0:pos0 + C]
        toks[0, :len(sl)] = sl
        logits, self.pool = paged_prefill_chunk(
            self.params, self.cfg, jnp.asarray(toks),
            jnp.asarray(pos0, jnp.int32),
            jnp.asarray(len(req.prompt), jnp.int32),
            jnp.asarray(self.page_table[req.slot]), self.pool,
            with_logits=last)
        req.prefill_pos = pos0 + C
        if last:
            self.prefilling.remove(req)
            self.running.append(req)
            self._finish_prefill(req, logits)

    def _finish_prefill(self, req: Request, logits) -> None:
        """Sample the first token from the prefill's last-position logits."""
        slot = req.slot
        if self._defer:
            first_dev = self._sample(logits)[0:1].astype(jnp.int32)
            if jax.default_backend() == "cpu":   # see step(): CPU donation race
                jax.block_until_ready(first_dev)
            req.first_dev = first_dev
            req.start_step = len(self._trace)
            req.n_generated = 1
            self._tokens_dev = self._tokens_dev.at[slot].set(first_dev[0])
        else:
            first = int(np.asarray(self._sample(logits))[0])
            req.generated.append(first)
            self.tokens[slot] = first
        self.lengths[slot] = len(req.prompt)
        self._dev_state = None          # new active slot + fresh length

    def _collect_device(self, req: Request) -> jax.Array:
        """Device-side 1-D token array of a completed request (deferred
        mode); the caller batches the host fetch across requests."""
        rows = self._trace[req.start_step:
                           req.start_step + req.n_generated - 1]
        parts = [req.first_dev]
        if rows:
            parts.append(jnp.stack(rows)[:, req.slot])
        return jnp.concatenate(parts)

    def _collect_tokens(self, req: Request) -> list[int]:
        """One host fetch for a single completed request (deferred mode)."""
        return [int(t) for t in np.asarray(self._collect_device(req))]

    def _sample(self, logits: jax.Array) -> jax.Array:
        self._step_no += 1
        key = jax.random.fold_in(self._key, self._step_no)
        return sample(logits, key, self.sampling)

    def _release(self, req: Request) -> None:
        self._dev_state = None          # slot leaves the active set
        self.running.remove(req)
        self.slot_req[req.slot] = None
        if self._nsched is None:           # native released its own pages
            self.allocator.release(req.pages)
        self.lengths[req.slot] = 1
        self.tokens[req.slot] = 0
        self.page_table[req.slot] = self.trash_page
        req.slot = req.pages = None
        req.done = True
