"""Context parallelism: ring attention (prefill) and cross-chip LSE-merged
decode.

The multi-chip extension of the reference's core idea (SURVEY §2.3 item 3,
§5 "long-context"): its split-KV blocks + associative (O, M, S) merge
(/root/reference/src/flash_row_float.h:191-198, 429-471) become, across
chips,

- prefill: KV shards ROTATE around the device ring (jax.lax.ppermute) while
  each chip runs the single-device attention on the block in front of
  it, folding per-step partials with the same ``lse_combine`` —
  communication overlapped with compute, point-to-point only (boom guide
  §16);
- decode: each chip computes a partial over its local KV shard
  (``flash_decode(..., return_partial=True)``) and one pmax+psum pair
  merges them (``lse_combine_axis``) — O(D) bytes per query instead of
  gathering the cache.

Both entry points are meant to be called INSIDE shard_map with the KV
sequence dimension sharded over ``axis_name``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ggml_cuda_experiments_tpu.ops.attention import attention
from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu.ops.lse import (
    AttnPartial, lse_combine, lse_combine_axis, lse_finalize,
)


def _partial_from_residuals(o: jax.Array, lse: jax.Array) -> AttnPartial:
    """(normalized o, lse) -> (o, m=lse, s=1) partial (valid since
    o_unnorm = o * s with s = exp(lse - m) = 1 when m := lse)."""
    return AttnPartial(
        o.astype(jnp.float32),
        lse[..., None],
        jnp.where(lse[..., None] == -jnp.inf, 0.0, 1.0),
    )


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    axis_name: str,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> jax.Array:
    """Ring attention over sequence-sharded Q/K/V (call inside shard_map).

    q, k, v: local shards [B, H, S_loc, D]; the global sequence is the
    concatenation over ``axis_name`` (same sharding for q and kv).
    causal: global causal masking (q position i attends kv j <= i).
    Returns the local output shard [B, H, S_loc, D].
    """
    n = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    B, H, S_loc, D = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]

    acc = AttnPartial(
        jnp.zeros((B, H, S_loc, D), jnp.float32),
        jnp.full((B, H, S_loc, 1), -jnp.inf, jnp.float32),
        jnp.zeros((B, H, S_loc, 1), jnp.float32),
    )
    k_blk, v_blk = k, v
    for step in range(n):
        src = (me - step) % n                      # owner of current block
        if causal:
            # additive mask from global positions: q_pos = me*S_loc + i,
            # kv_pos = src*S_loc + j; allow kv_pos <= q_pos
            qpos = me * S_loc + jnp.arange(S_loc)[:, None]
            kpos = src * S_loc + jnp.arange(S_loc)[None, :]
            mask = jnp.where(kpos <= qpos, 0.0, -jnp.inf).astype(jnp.float32)
            mask = mask[None, None]
        else:
            mask = None
        o, lse = attention(q, k_blk, v_blk, mask, scale=scale,
                           return_residuals=True)
        acc = lse_combine(acc, _partial_from_residuals(o, lse))
        if step != n - 1:
            # rotate: send our current block to the right neighbor while
            # the next step's compute proceeds (XLA overlaps the ppermute
            # with the next kernel when schedules allow)
            k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
            v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
    return lse_finalize(acc, out_dtype=q.dtype)


def ulysses_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    axis_name: str,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> jax.Array:
    """Ulysses-style sequence parallelism (call inside shard_map).

    The alternative to ring attention (SURVEY §5): activations arrive
    sequence-sharded [B, H, S_loc, D]; two all-to-alls re-shard heads<->
    sequence so each device runs plain attention on ALL positions of
    H/n heads, then shard back. Two collectives of O(local activations)
    instead of N-1 ppermutes of KV — wins when H/n >= 1 and the sequence is
    short relative to head count; ring wins for very long context.
    """
    n = jax.lax.axis_size(axis_name)
    B, H, S_loc, D = q.shape
    assert H % n == 0, f"Ulysses needs heads {H} divisible by axis size {n}"

    def to_heads(x):
        # [B, H, S_loc, D] -> [B, H/n, S, D]: split heads, concat sequence
        return jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                                  tiled=True)

    q2, k2, v2 = to_heads(q), to_heads(k), to_heads(v)
    o2 = attention(q2, k2, v2, causal=causal, scale=scale)
    # back to sequence sharding: split sequence, concat heads
    return jax.lax.all_to_all(o2, axis_name, split_axis=2, concat_axis=1,
                              tiled=True)


def decode_context_parallel(
    q: jax.Array,
    k_shard: jax.Array,
    v_shard: jax.Array,
    lengths_local: jax.Array,
    axis_name: str,
    *,
    scale: float | None = None,
    kv_splits: int | None = None,
    block_k: int | None = None,
    impl: str | None = None,
) -> jax.Array:
    """Context-parallel single-token decode (call inside shard_map).

    q: [B, Hq, D] replicated over ``axis_name``; k/v_shard: this chip's
    [B, Hkv, S_loc, D] slice of the cache; lengths_local: [B] valid tokens
    *within this shard*. Returns [B, Hq, D] (identical on every chip).
    """
    part = flash_decode(
        q, k_shard, v_shard, lengths_local, scale=scale,
        kv_splits=kv_splits, block_k=block_k, return_partial=True,
        impl=impl,
    )
    merged = lse_combine_axis(part, axis_name)
    return lse_finalize(merged, out_dtype=q.dtype)
