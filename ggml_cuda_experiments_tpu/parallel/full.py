"""The combined 5-axis parallel step: data / pipe / seq / model / expert.

Composes every parallelism layer in this package into ONE shard_map-ed SPMD
program over a 5-axis mesh (the driver's tp/pp/dp/sp/ep contract):

    data    batch sharding                       (no collectives)
    pipe    layer stages, ppermute microbatch pipeline   (parallel/pipeline)
    seq     sequence/context parallelism: ring attention for prefill,
            LSE-merged partial flash decode for decode   (parallel/ring_attention)
    model   Megatron tensor parallel: heads/col-row sharding, one psum
            per attention block                           (parallel/tp)
    expert  MoE expert sharding, one psum per MLP         (models/moe)

Sequence-shard convention (block-contiguous, owner-writes):
    prefill  tokens are P("seq") over T: seq-shard i computes and STORES
             positions [i*T_loc, (i+1)*T_loc) in ITS local cache shard at
             offsets [0, T_loc); ring attention provides global causal
             attention (ppermute KV rotation + associative LSE merge —
             the cross-chip form of the reference's split-KV combine,
             /root/reference/src/flash_row_float.h:429-471).
    decode   the new token's KV appends to the LAST seq shard (offset
             T_loc + step); every shard computes an (O, M, S) partial over
             its local KV and lse_combine_axis merges — O(D) bytes per
             query over the interconnect instead of gathering the cache.

The reference is single-process (SURVEY §2.3); all five axes here are new
capability, built on XLA collectives (NCCL on the GPU).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ggml_cuda_experiments_tpu.models import llama
from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.parallel import pipeline
from ggml_cuda_experiments_tpu.parallel.ring_attention import (
    decode_context_parallel, ring_attention,
)

AXES = ("data", "pipe", "seq", "model", "expert")


def make_full_mesh(n_devices: int, sizes: dict[str, int] | None = None
                   ) -> Mesh:
    """5-axis mesh over the first n_devices devices.

    Without explicit ``sizes``, n's prime factors are dealt round-robin to
    (model, pipe, seq, expert, data) — model first so tensor-parallel
    collectives land on the fastest (innermost, NVLink-joined) axis, data
    last (it needs no forward-pass collectives, so a slower link suffices).
    """
    if sizes is None:
        sizes = dict.fromkeys(AXES, 1)
        order = ("model", "pipe", "seq", "expert", "data")
        rem, i = n_devices, 0
        while rem > 1:
            for p in (2, 3, 5, 7, 11, 13):
                if rem % p == 0:
                    sizes[order[i % len(order)]] *= p
                    rem //= p
                    i += 1
                    break
            else:
                sizes["data"] *= rem
                rem = 1
    n = int(np.prod(list(sizes.values())))
    devices = np.array(jax.devices()[:n]).reshape(
        *(sizes[a] for a in AXES))
    return Mesh(devices, AXES)


def _sp_attention_block(seq_axis: str, prefill_t_loc: int):
    """llama._attention_block variant with sequence/context parallelism.

    ``prefill_t_loc``: per-shard prefill length (static at trace time) —
    fixes the owner-writes storage map for decode appends."""

    def block(layer, cfg, h, cache, li, positions, *, decode, reduce_axis,
              b0=0, valid=None):
        B, T, _ = h.shape
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        n_seq = jax.lax.axis_size(seq_axis)
        me = jax.lax.axis_index(seq_axis)
        lengths = jax.lax.dynamic_slice_in_dim(cache.lengths, b0, B)
        if valid is None:
            valid = jnp.bool_(True)

        x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
        q, k, v = llama.qkv_proj(layer, x, cfg)
        q = llama.rope(q.reshape(B, T, Hq, D), positions, cfg.rope_theta)
        k = llama.rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
        v = v.reshape(B, T, Hkv, D)
        kt = k.transpose(0, 2, 1, 3)       # [B, Hkv, T, D]
        vt = v.transpose(0, 2, 1, 3)

        if decode:
            # owner-writes: the new token appends to the LAST seq shard
            step = lengths - n_seq * prefill_t_loc   # decode steps so far
            store = prefill_t_loc + step             # local write offset
            w_valid = valid & (me == n_seq - 1)
        else:
            # prefill: this shard stores its own block at local offset 0
            store = positions[:, 0] - me * prefill_t_loc
            w_valid = valid
        cache = llama.KVCache(
            k=llama._write_cache_layer(cache.k, li, kt, store, b0, w_valid),
            v=llama._write_cache_layer(cache.v, li, vt, store, b0, w_valid),
            lengths=cache.lengths,
        )

        if decode:
            def layer_rows(arr):
                sizes = (1, B) + arr.shape[2:]
                return jax.lax.dynamic_slice(
                    arr, (li, b0) + (0,) * (arr.ndim - 2), sizes)[0]

            len_local = jnp.clip(prefill_t_loc
                                 + jnp.where(me == n_seq - 1, step + 1, 0),
                                 0, cache.k.shape[3])
            o = decode_context_parallel(
                q[:, 0], layer_rows(cache.k), layer_rows(cache.v),
                len_local, seq_axis,
            )[:, None]                      # [B, 1, Hq, D]
        else:
            o = ring_attention(
                q.transpose(0, 2, 1, 3), kt, vt, seq_axis, causal=True,
            ).transpose(0, 2, 1, 3)         # [B, T, Hq, D]

        o = o.reshape(B, T, Hq * D).astype(h.dtype)
        out = llama.apply_linear(o, layer["wo"], xq8=cfg.x_quant8)
        if reduce_axis is not None:
            out = jax.lax.psum(out, reduce_axis)
        return out, cache

    return block


def shard_full_params(params: llama.Params, mesh: Mesh, cfg: ModelConfig
                      ) -> tuple[llama.Params, llama.Params]:
    """Stack layers and shard over (pipe, model|expert): attention weights
    Megatron col/row over ``model``, MoE expert stacks over ``expert``,
    embed/norms/head replicated. Returns (sharded_params, specs)."""
    stacked = pipeline.stack_layers(params)
    tp_extra = {
        "wq": ("model",), "wk": ("model",), "wv": ("model",),
        "wqkv": ("model",),
        "wo": (None, "model"),
        "router": (), "w_gate": ("expert",), "w_up": ("expert",),
        "w_down": ("expert",),
    }
    lspecs = pipeline.stacked_layer_specs(stacked["layers"], tp_extra)
    pspecs = dict(embed=P(None, None), final_norm=P(None),
                  lm_head=P(None, None), layers=lspecs)
    sharded = jax.tree.map(
        lambda w, s: jax.device_put(w, NamedSharding(mesh, s)),
        stacked, pspecs, is_leaf=lambda x: isinstance(x, P))
    return sharded, pspecs


def full_cache_specs() -> llama.KVCache:
    return llama.KVCache(k=P("pipe", "data", "model", "seq", None),
                         v=P("pipe", "data", "model", "seq", None),
                         lengths=P("data"))


def make_full_step(cfg: ModelConfig, mesh: Mesh, pspecs, *, n_micro: int,
                   prefill_len: int, decode: bool):
    """Jitted 5-axis step. prefill_len: GLOBAL prompt length (sets the
    per-shard storage map; must be a multiple of seq axis size)."""
    n_seq = mesh.shape["seq"]
    n_model = mesh.shape["model"]
    assert prefill_len % n_seq == 0
    t_loc = prefill_len // n_seq
    lcfg = dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // n_model,
        n_kv_heads=cfg.n_kv_heads // n_model,
    )
    attn = _sp_attention_block("seq", t_loc)
    cspecs = full_cache_specs()
    tok_spec = P("data") if decode else P("data", "seq")

    def step(params, tokens, cache):
        if decode:
            tokens = tokens[:, None]
        logits, cache = pipeline.pp_forward(
            params, lcfg, tokens, cache, decode=decode, n_micro=n_micro,
            reduce_axis="model", expert_axis="expert", seq_axis="seq",
            attention_block=attn)
        if not decode:
            # only the last seq shard's logits are the global last token's
            last = jax.lax.axis_index("seq") == n_seq - 1
            logits = jax.lax.psum(
                jnp.where(last, logits, 0.0), "seq")
        return logits, cache

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(pspecs, tok_spec, cspecs),
        out_specs=(P("data", None), cspecs),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(2,))


def create_full_cache(cfg: ModelConfig, mesh: Mesh, batch: int,
                      max_len: int, dtype=jnp.bfloat16) -> llama.KVCache:
    cache = llama.KVCache.create(cfg, batch, max_len, dtype)
    cs = full_cache_specs()
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        cache, cs, is_leaf=lambda x: isinstance(x, P))
