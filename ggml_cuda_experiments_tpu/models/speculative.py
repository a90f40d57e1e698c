"""Speculative decoding + chunked verify/prefill.

Decode is HBM-bound: every token streams all 4-bit weights once (~4.2 GB
for 7B), so tokens/s is capped by bandwidth no matter how fast the kernels
are. Speculative decoding breaks the cap: a small DRAFT model proposes
``gamma`` tokens autoregressively, then the TARGET model scores the whole
window in ONE forward pass (γ+1 positions share one weight stream — the
memory cost of a single decode step). Greedy acceptance keeps the output
IDENTICAL to plain greedy decoding of the target (lossless; tested).

The verify pass is the missing multi-token-with-cache forward: write the
window's KV at positions len..len+T, attend over cache[0:len+T] with
intra-window causal masking. The same ``chunk_step`` powers chunked
prefill (long prompts processed in fixed-size chunks against the growing
cache, bounding prefill activation memory).

Cache rollback is free by construction: the KV cache is position-indexed
with an explicit ``lengths`` pointer, so rejecting draft tokens just
rewinds ``lengths`` — stale slots are masked out by every kernel and
overwritten by the next window (the same invariant the reference's
split-KV kernels rely on for partially-filled blocks,
/root/reference/src/flash_row_float.h:191-198).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ggml_cuda_experiments_tpu.models import llama
from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.ops.attention import attention


def _chunk_attention(layer, cfg: ModelConfig, h, cache: llama.KVCache,
                     li: int, positions):
    """Attention for a T-token window at positions len..len+T over an
    existing cache prefix. Returns (attn_out, cache with window written)."""
    B, T, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert not cache.quantized, "chunked verify needs the bf16 cache"
    lengths = cache.lengths

    x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    q, k, v = llama.qkv_proj(layer, x, cfg)
    q = llama.rope(q.reshape(B, T, Hq, D), positions, cfg.rope_theta)
    k = llama.rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
    v = v.reshape(B, T, Hkv, D)
    kt = k.transpose(0, 2, 1, 3)
    vt = v.transpose(0, 2, 1, 3)
    cache = llama.KVCache(
        k=llama._write_cache_layer(cache.k, li, kt, lengths),
        v=llama._write_cache_layer(cache.v, li, vt, lengths),
        lengths=lengths,
    )

    # attend over the whole (static-size) cache, masked to kv_pos <= q_pos
    S = cache.k.shape[3]
    kv_pos = jnp.arange(S, dtype=jnp.int32)[None, None, None, :]
    q_pos = positions[:, None, :, None]                  # [B, 1, T, 1]
    mask = jnp.where(kv_pos <= q_pos, 0.0, -jnp.inf).astype(jnp.float32)
    o = attention(
        q.transpose(0, 2, 1, 3), cache.k[li], cache.v[li], mask,
    ).transpose(0, 2, 1, 3)                              # [B, T, Hq, D]

    o = o.reshape(B, T, Hq * D).astype(h.dtype)
    out = llama.apply_linear(o, layer["wo"], xq8=cfg.x_quant8)
    return out, cache


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnames=("cache",))
def chunk_step(params: llama.Params, cfg: ModelConfig, tokens: jax.Array,
               cache: llama.KVCache
               ) -> tuple[jax.Array, llama.KVCache]:
    """Forward a T-token window against an existing cache prefix.

    tokens: [B, T] appended at positions lengths..lengths+T.
    Returns (logits [B, T, vocab] for every window position, cache with
    the window's KV written and lengths += T). For verify-then-rollback,
    rewind with ``rewind(cache, n)``.
    """
    B, T = tokens.shape
    positions = cache.lengths[:, None] + jnp.arange(T, dtype=jnp.int32)
    h = params["embed"][tokens]
    for li, layer in enumerate(params["layers"]):
        attn, cache = _chunk_attention(layer, cfg, h, cache, li, positions)
        h = h + attn
        h = h + llama._mlp_block(layer, cfg, h)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h, params["lm_head"], xq8=cfg.x_quant8)
    cache = dataclasses.replace(cache, lengths=cache.lengths + T)
    return logits.astype(jnp.float32), cache


def rewind(cache: llama.KVCache, n) -> llama.KVCache:
    """Roll the cache back n tokens (stale KV is masked by lengths)."""
    return dataclasses.replace(cache, lengths=cache.lengths - n)


def prefill_chunked(params: llama.Params, cfg: ModelConfig,
                    tokens: jax.Array, cache: llama.KVCache,
                    chunk: int = 256) -> tuple[jax.Array, llama.KVCache]:
    """Chunked prefill: process a [B, T] prompt ``chunk`` tokens at a time
    against the growing cache (activation memory O(chunk), not O(T)).
    Returns last-position logits and the filled cache."""
    B, T = tokens.shape
    logits = None
    for t0 in range(0, T, chunk):
        logits, cache = chunk_step(params, cfg, tokens[:, t0:t0 + chunk],
                                   cache)
    return logits[:, -1], cache


@functools.partial(
    jax.jit, static_argnames=("tcfg", "dcfg", "gamma", "windows"),
    donate_argnames=("tcache", "dcache"))
def speculative_scan(tparams, tcfg: ModelConfig, dparams, dcfg: ModelConfig,
                     cur: jax.Array, tcache: llama.KVCache,
                     dcache: llama.KVCache, *, gamma: int = 4,
                     windows: int = 8):
    """``windows`` greedy speculative windows fully ON DEVICE (lax.scan):
    draft scan (gamma cheap steps) -> one target verify pass -> acceptance
    count -> cache rewind, with no host round-trip anywhere. The host-loop
    ``speculative_generate`` syncs per draft token, so its time is
    host round trips; this is both the production form and the only
    honest way to benchmark it.

    The draft cache is filled UNCONDITIONALLY with the last draft token
    and then rewound by (gamma - n_acc) — uniform control flow replaces
    the host version's accept-dependent branch at the cost of one cheap
    draft step per window.

    cur: [1] the current greedy token (already emitted). Returns
    (tokens [windows, gamma+1] with row w valid through counts[w],
    counts [windows] = n_acc+1, cur' [1], tcache, dcache). The
    concatenated valid rows equal greedy decoding of the target exactly
    (same property as speculative_generate; tested)."""
    assert tcache.lengths.shape[0] == 1, "batch-1 latency feature"

    def window_body(carry, _):
        cur, tcache, dcache = carry

        def dstep(c, _):
            tok, dc = c
            logits, dc = llama.decode_step(dparams, dcfg, tok, dc)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            return (nxt, dc), nxt

        (_, dcache), draft = jax.lax.scan(
            dstep, (cur, dcache), None, length=gamma)      # draft [γ, 1]
        draft = draft[:, 0]                                # [γ]

        window = jnp.concatenate([cur, draft])[None, :]    # [1, γ+1]
        vlogits, tcache = chunk_step(tparams, tcfg, window, tcache)
        preds = jnp.argmax(vlogits[0], -1).astype(jnp.int32)   # [γ+1]

        match = (preds[:gamma] == draft).astype(jnp.int32)
        n_acc = jnp.sum(jnp.cumprod(match))                # leading accepts
        idx = jnp.arange(gamma + 1)
        drafted_pad = jnp.concatenate([draft, jnp.zeros(1, jnp.int32)])
        bonus = preds[n_acc]
        emitted = jnp.where(idx < n_acc, drafted_pad,
                            jnp.where(idx == n_acc, bonus, -1))

        # target wrote γ+1 positions; pointer belongs at +(n_acc+1)
        tcache = rewind(tcache, gamma - n_acc)
        # draft wrote γ (cur, d1..dγ-1); fill dγ unconditionally, rewind
        _, dcache = llama.decode_step(
            dparams, dcfg, draft[-1:], dcache)
        dcache = rewind(dcache, gamma - n_acc)
        return (bonus[None], tcache, dcache), (emitted, n_acc + 1)

    (cur, tcache, dcache), (toks, counts) = jax.lax.scan(
        window_body, (cur, tcache, dcache), None, length=windows)
    return toks, counts, cur, tcache, dcache


def speculative_generate(
    tparams: llama.Params, tcfg: ModelConfig,
    dparams: llama.Params, dcfg: ModelConfig,
    prompt: jax.Array, steps: int, *, gamma: int = 4,
    max_len: int | None = None, cache_dtype=jnp.bfloat16,
) -> tuple[np.ndarray, dict]:
    """Greedy speculative decoding: same output as greedy decoding of the
    target alone (exact up to kernel numerics — the verify pass scores the
    window with the flash-attention kernel while stepwise decode uses the
    flash-decode kernel, so bf16 accumulation can flip near-tied argmaxes;
    in f32 the equality is tested exactly), at up to (gamma+1)x fewer
    target weight streams.

    prompt: [1, T] (speculative decoding is a batch-1 latency feature).
    Returns (tokens [1, steps], stats dict with acceptance counters).
    """
    B, T = prompt.shape
    assert B == 1, "speculative decoding is the batch-1 latency path"
    max_len = max_len or llama._round_up(T + steps + gamma + 2, 256)

    tcache = llama.KVCache.create(tcfg, B, max_len, cache_dtype)
    dcache = llama.KVCache.create(dcfg, B, max_len, cache_dtype)

    tlogits, tcache = llama.prefill(tparams, tcfg, prompt, tcache)
    _, dcache = llama.prefill(dparams, dcfg, prompt, dcache)

    out: list[int] = []
    stats = {"verify_calls": 0, "drafted": 0, "accepted": 0}
    cur = int(np.asarray(jnp.argmax(tlogits, -1))[0])

    while len(out) < steps:
        out.append(cur)
        if len(out) >= steps:
            break
        # -- draft gamma tokens autoregressively --------------------------
        draft = []
        dtok = jnp.asarray([cur], jnp.int32)
        for _ in range(gamma):
            dlogits, dcache = llama.decode_step(dparams, dcfg, dtok, dcache)
            dtok = jnp.argmax(dlogits, -1).astype(jnp.int32)
            draft.append(int(np.asarray(dtok)[0]))
        # -- target verifies the whole window in one pass ------------------
        window = jnp.asarray([[cur] + draft], jnp.int32)     # [1, γ+1]
        vlogits, tcache = chunk_step(tparams, tcfg, window, tcache)
        preds = np.asarray(jnp.argmax(vlogits, -1))[0]       # [γ+1]
        stats["verify_calls"] += 1
        stats["drafted"] += gamma

        n_acc = 0
        while n_acc < gamma and preds[n_acc] == draft[n_acc]:
            n_acc += 1
        stats["accepted"] += n_acc
        # tokens at global indices n+1..n+n_acc+1 (n = cur's index):
        # the accepted draft prefix plus the target's own next token
        emitted = draft[:n_acc] + [int(preds[n_acc])]
        # target cache wrote [cur, d1..dγ] at n..n+γ (lengths = n+γ+1);
        # the next cur sits at index n+n_acc+1 -> rewind the rejected tail
        # (contents up to the pointer are exactly the accepted tokens)
        tcache = rewind(tcache, gamma - n_acc)
        # draft cache wrote [cur, d1..dγ-1] (lengths = n+γ). Rewinding to
        # n+n_acc+1 keeps KV that is ALREADY correct (positions n+1..
        # n+n_acc hold d1..d_n_acc); only the all-accepted case is missing
        # dγ's KV and needs one fill step.
        if n_acc < gamma:
            dcache = rewind(dcache, gamma - n_acc - 1)
        else:
            _, dcache = llama.decode_step(
                dparams, dcfg, jnp.asarray([draft[-1]], jnp.int32), dcache)
        out.extend(emitted[:-1])
        out = out[:steps]
        cur = emitted[-1]

    return np.asarray(out[:steps], np.int32)[None], stats
