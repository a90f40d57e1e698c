"""Pipeline parallelism: layer stages over a ``pipe`` mesh axis.

The reference is single-process (SURVEY §2.3); this covers the ``pp`` axis
of the driver's parallelism contract, as one SPMD program:

- **Stage sharding is array sharding.** Every per-layer weight is stacked
  with a leading ``n_layers`` dim and sharded ``P("pipe")`` — stage s holds
  layers [s*L/P, (s+1)*L/P) as ordinary local arrays inside ``shard_map``;
  the KV cache's layer dim shards the same way, so each stage owns exactly
  its layers' cache. No per-stage program, no send/recv framework: ONE
  SPMD program where stage identity is ``lax.axis_index``.
- **GPipe-style microbatching with `ppermute` handoff.** The batch splits
  into M microbatches; at pipeline step t, stage s runs microbatch t-s
  through its local layers and `ppermute`s activations to stage s+1 (a
  point-to-point hop — an NCCL send under XLA). Bubble steps
  (t-s outside [0, M)) compute on garbage but their cache writes are
  masked out (``valid``) and their outputs discarded.
- Works for prefill (flash-attention) and decode (split-KV flash decode),
  with tensor parallelism (``reduce_axis``) and expert parallelism
  (``expert_axis``) composing inside the stage body.

Efficiency: pipeline utilization is M/(M+P-1); decode latency-bound serving
normally runs pp only across hosts where tp would leave NVLink (the classic
7B-fits-on-a-chip case needs neither). This module makes pp available and
correct; the mesh layout chooses when to use it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ggml_cuda_experiments_tpu.models import llama
from ggml_cuda_experiments_tpu.models.config import ModelConfig


def stack_layers(params: llama.Params) -> llama.Params:
    """Replace the per-layer list with one stacked pytree (leading dim =
    n_layers) whose leaves can be sharded over the ``pipe`` axis.
    QuantLinear leaves stack field-wise (same static fmt/shape)."""
    out = dict(params)
    out["layers"] = jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *params["layers"])
    return out


def stacked_layer_specs(stacked_layers, extra=None):
    """P("pipe", ...) specs for the stacked layer tree. ``extra`` maps a
    leaf (by its path through the layer dict, e.g. "wq") to additional
    axis names after the pipe dim (tensor-parallel col/row sharding)."""
    def spec(path, leaf):
        key = path[0].key if path else None
        tail = (extra or {}).get(key, ())
        return P("pipe", *tail)
    return jax.tree_util.tree_map_with_path(spec, stacked_layers)


def _index_layers(stacked, li: int):
    return jax.tree.map(lambda a: a[li], stacked)


def pp_forward(params: llama.Params, cfg: ModelConfig, tokens: jax.Array,
               cache: llama.KVCache, *, decode: bool, n_micro: int,
               axis_name: str = "pipe", reduce_axis: str | None = None,
               expert_axis: str | None = None, seq_axis: str | None = None,
               attention_block=None) -> tuple[jax.Array, llama.KVCache]:
    """Pipelined forward (call inside shard_map; params["layers"] stacked
    and pipe-sharded, cache layer-dim pipe-sharded).

    tokens: [B, T] (T=1 for decode); B % n_micro == 0.
    ``seq_axis``: prefill tokens are additionally sequence-sharded over
    this axis (positions offset per shard; attention must be a
    sequence-parallel ``attention_block``, e.g. parallel/full.py's).
    ``attention_block``: drop-in replacement for llama._attention_block
    (same signature) — the hook sequence parallelism plugs into.
    Returns (logits [B, vocab] — identical on every stage — and the
    updated local cache shard).
    """
    n_stage = jax.lax.axis_size(axis_name)
    stage = jax.lax.axis_index(axis_name)
    B, T = tokens.shape
    assert B % n_micro == 0, f"batch {B} % microbatches {n_micro} != 0"
    b = B // n_micro
    layers = params["layers"]
    l_loc = jax.tree.leaves(layers)[0].shape[0]   # layers per stage
    attn_block = attention_block or llama._attention_block

    if decode:
        positions = cache.lengths[:, None]
        len_inc = 1
    else:
        positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
        if seq_axis is not None:
            # block-contiguous sequence sharding: this shard's tokens are
            # global positions [i*T, (i+1)*T)
            positions = positions + jax.lax.axis_index(seq_axis) * T
        len_inc = T * (jax.lax.axis_size(seq_axis)
                       if seq_axis is not None else 1)

    # embed all microbatches up front (embed table is replicated; only
    # stage 0's result enters the pipeline, the rest is dead code XLA DCEs)
    h_all = params["embed"][tokens]               # [B, T, dim]
    dim = h_all.shape[-1]
    h_mb = h_all.reshape(n_micro, b, T, dim)
    pos_mb = positions.reshape(n_micro, b, T)

    vocab = (params["lm_head"].shape[0]
             if hasattr(params["lm_head"], "shape") else cfg.vocab_size)
    logits_buf = jnp.zeros((n_micro, b, vocab), jnp.float32)
    carry = jnp.zeros((b, T, dim), h_all.dtype)
    fwd_perm = [(i, i + 1) for i in range(n_stage - 1)]

    for t in range(n_micro + n_stage - 1):
        mb = t - stage                            # this stage's microbatch
        valid = (mb >= 0) & (mb < n_micro)
        mb_c = jnp.clip(mb, 0, n_micro - 1)
        b0 = mb_c * b

        inp = jnp.where(stage == 0,
                        jax.lax.dynamic_index_in_dim(h_mb, mb_c, 0, False),
                        carry)
        pos = jax.lax.dynamic_index_in_dim(pos_mb, mb_c, 0, False)

        h = inp
        for li in range(l_loc):
            layer = _index_layers(layers, li)
            attn, cache = attn_block(
                layer, cfg, h, cache, li, pos, decode=decode,
                reduce_axis=reduce_axis, b0=b0, valid=valid)
            h = h + attn
            h = h + llama._mlp_block(layer, cfg, h,
                                     reduce_axis=reduce_axis,
                                     expert_axis=expert_axis)

        # last stage: head + collect this microbatch's logits
        hn = llama.rms_norm(h[:, -1], params["final_norm"], cfg.rms_eps)
        logits = llama.apply_linear(hn, params["lm_head"],
                                    xq8=cfg.x_quant8).astype(jnp.float32)
        take = valid & (stage == n_stage - 1)
        cur = jax.lax.dynamic_index_in_dim(logits_buf, mb_c, 0, False)
        logits_buf = jax.lax.dynamic_update_index_in_dim(
            logits_buf, jnp.where(take, logits, cur), mb_c, 0)

        if t != n_micro + n_stage - 2:
            carry = jax.lax.ppermute(h, axis_name, fwd_perm)

    # broadcast the last stage's logits to every stage (only it wrote)
    logits_all = jax.lax.psum(logits_buf, axis_name).reshape(B, vocab)
    cache = dataclasses.replace(cache, lengths=cache.lengths + len_inc)
    return logits_all, cache


def make_pp_step(cfg: ModelConfig, mesh: Mesh, params: llama.Params, *,
                 n_micro: int, decode: bool):
    """Jitted pipeline-parallel step over a mesh with a ``pipe`` axis.

    ``params`` must already be stacked (``stack_layers``); returns
    (sharded_params, step_fn) where step_fn(params, tokens, cache) ->
    (logits, cache)."""
    lspecs = stacked_layer_specs(params["layers"])
    pspecs = dict(
        embed=P(None, None), final_norm=P(None), lm_head=P(None, None),
        layers=lspecs,
    )
    cspecs = llama.KVCache(k=P("pipe"), v=P("pipe"), lengths=P(None))

    def step(params, tokens, cache):
        return pp_forward(params, cfg, tokens, cache, decode=decode,
                          n_micro=n_micro)

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(pspecs, P(None, None), cspecs),
        out_specs=(P(None, None), cspecs),
        check_vma=False,
    )
    sp = jax.tree.map(
        lambda s: NamedSharding(mesh, s), pspecs,
        is_leaf=lambda x: isinstance(x, P))
    sparams = jax.tree.map(jax.device_put, params, sp)
    return sparams, jax.jit(sharded, donate_argnums=(2,))


def shard_cache_pp(cache: llama.KVCache, mesh: Mesh) -> llama.KVCache:
    ns = lambda s: NamedSharding(mesh, s)
    return llama.KVCache(
        k=jax.device_put(cache.k, ns(P("pipe"))),
        v=jax.device_put(cache.v, ns(P("pipe"))),
        lengths=jax.device_put(cache.lengths, ns(P(None))),
        k_scale=None if cache.k_scale is None else
        jax.device_put(cache.k_scale, ns(P("pipe"))),
        v_scale=None if cache.v_scale is None else
        jax.device_put(cache.v_scale, ns(P("pipe"))),
    )
