#!/usr/bin/env python
"""Decompose batch-1 decode latency into components, on the card.

Times, via the chained-marginal method (dispatch-free):
  1. each distinct fused matvec shape of the model, weighted by count/layer
  2. the attention decode kernel at the model's cache shape
  3. RoPE+norms+cache-update glue (full step minus the above)
  4. the full decode step

Usage: python tools/profile_decode.py [--model tinyllama-1.1b] [--fmt q4_k]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import numpy as np
import jax.numpy as jnp


def marginal(fn_maker, n_small=16, n_big=80, reps=2):
    """Best-of marginal seconds/iter between two chained lengths."""
    def run(n):
        f = fn_maker(n)
        jax.block_until_ready(f())          # compile + warm
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            best = min(best, time.perf_counter() - t0)
        return best
    return (run(n_big) - run(n_small)) / (n_big - n_small)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--fmt", default="q4_k")
    ap.add_argument("--cache", type=int, default=1024)
    args = ap.parse_args()

    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
    from ggml_cuda_experiments_tpu.utils.device_info import chip_spec
    from ggml_cuda_experiments_tpu.utils.platform import enable_compile_cache

    import dataclasses
    enable_compile_cache()
    peak_gbs = chip_spec().hbm_bytes_per_s / 1e9
    # match bench.py's config: int8-quantized activations
    cfg = dataclasses.replace(PRESETS[args.model], x_quant8=True)
    rng = np.random.default_rng(0)
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim

    # the real decode-path shapes: fused wqkv / w_gu weights, as
    # llama.quantize_params builds them
    inter_p = cfg.intermediate
    shapes = [  # (name, N, K, count per layer)
        ("wqkv", (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d, 1),
        ("wo", d, cfg.n_heads * hd, 1),
        ("w_gu", 2 * inter_p, d, 1),
        ("w_down", d, inter_p, 1),
    ]
    xq8 = cfg.x_quant8
    total_matvec = 0.0
    for name, N, K, cnt in shapes:
        w = (rng.normal(size=(N, K)) / np.sqrt(K)).astype(np.float32)
        ql = jax.device_put(qm.quantize(w, args.fmt))
        x0 = jnp.asarray(rng.normal(size=(1, K)).astype(np.float32))

        def maker(n, ql=ql, x0=x0, N=N, K=K):
            @jax.jit
            def f():
                def body(_, x):
                    y = qm.qmatmul(x, ql, x_quant8=xq8)
                    x = y[:, :K] if N >= K else jnp.pad(y, ((0, 0), (0, K - N)))
                    return x * jax.lax.rsqrt(jnp.mean(x * x) + 1e-6)
                return jax.lax.fori_loop(0, n, body, x0)
            return f
        us = marginal(maker) * 1e6
        bw = ql.nbytes / (us / 1e6) / 1e9
        total_matvec += us * cnt * L
        print(f"matvec {name:7s} [{N:6d}x{K:6d}] x{cnt}/layer: {us:7.1f} us "
              f"({bw:5.0f} GB/s, {100*bw/peak_gbs:4.1f}%)", flush=True)

    # lm_head (once per token)
    w = (rng.normal(size=(cfg.vocab_size, d)) / np.sqrt(d)).astype(np.float32)
    ql = jax.device_put(qm.quantize(w, args.fmt))
    x0 = jnp.asarray(rng.normal(size=(1, d)).astype(np.float32))

    def head_maker(n, ql=ql, x0=x0):
        @jax.jit
        def f():
            def body(_, x):
                y = qm.qmatmul(x, ql, x_quant8=xq8)
                return x * jax.lax.rsqrt(jnp.mean(y * y) + 1e-6)
            return jax.lax.fori_loop(0, n, body, x0)
        return f
    head_us = marginal(head_maker) * 1e6
    print(f"matvec lm_head [{cfg.vocab_size:6d}x{d:6d}] x1/token: "
          f"{head_us:7.1f} us", flush=True)

    # attention decode at the model's real cache dtype (bf16) and a
    # realistic short valid length (the bench decodes from a 16-tok prompt)
    kd = jnp.asarray(rng.normal(
        size=(1, cfg.n_kv_heads, args.cache, hd)).astype(np.float32),
        jnp.bfloat16)
    vd = jnp.asarray(rng.normal(
        size=(1, cfg.n_kv_heads, args.cache, hd)).astype(np.float32),
        jnp.bfloat16)
    for ctx in (64, args.cache):
        lens = jnp.full((1,), ctx, jnp.int32)

        def attn_maker(n, lens=lens):
            @jax.jit
            def f():
                def body(_, q):
                    o = flash_decode(q, kd, vd, lens)
                    return (o * jax.lax.rsqrt(jnp.mean(o * o) + 1e-6)
                            ).astype(jnp.bfloat16)
                # bf16 q to match the cache dtype
                q0 = jnp.ones((1, cfg.n_heads, hd), jnp.bfloat16)
                return jax.lax.fori_loop(0, n, body, q0)
            return f
        attn_us = marginal(attn_maker) * 1e6
        print(f"flash_decode [cache {args.cache}, len {ctx:5d}]: "
              f"{attn_us:7.1f} us/layer", flush=True)

    # full decode step
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=0, as_numpy=True), args.fmt)
    params = jax.device_put(params)
    cache = llama.KVCache.create(cfg, 1, args.cache)
    tok = jnp.zeros((1,), jnp.int32)

    def step_maker(n):
        @jax.jit
        def g(params, tok, cache):   # params as args, not captured consts
            def body(_, carry):
                tok, cache = carry
                logits, cache = llama.decode_step(params, cfg, tok, cache)
                return jnp.argmax(logits, -1).astype(jnp.int32), cache
            return jax.lax.fori_loop(0, n, body, (tok, cache))[0]
        return lambda: g(params, tok, cache)
    step_us = marginal(step_maker, n_small=8, n_big=40) * 1e6

    comp = total_matvec + head_us + attn_us * L
    print("-" * 60)
    print(f"sum of matvecs : {(total_matvec+head_us)/1e3:7.2f} ms/token "
          f"(incl. lm_head)")
    print(f"attention      : {attn_us*L/1e3:7.2f} ms/token ({L} layers, "
          f"full cache)")
    print(f"full step      : {step_us/1e3:7.2f} ms/token "
          f"({1e6/step_us:.1f} tok/s)")
    print(f"glue/overhead  : {(step_us-comp)/1e3:7.2f} ms")


if __name__ == "__main__":
    main()
