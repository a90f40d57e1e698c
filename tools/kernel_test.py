#!/usr/bin/env python
"""Randomized kernel correctness + timing harness — the analog of the
reference's ``kernel_test`` CLI (/root/reference/src/kernel_test.h:1-249).

Flag parity map (kernel_test.h:5-21):
    --kv-size N        KV length, min 256 (same default semantics)
    --no-kv-parallel   single-pass decode instead of split-KV + merge
    --kv-splits N      split count for the split-KV path (the analog of the
                       reference's kv_size/256 grid; its --n-warps knob has
                       no meaning here — the split grid replaces it)
    --head-dim, --heads, --kv-heads   shapes (defaults = the reference's
                       GQA config: 128 / 32 q heads / 8 kv heads,
                       kernel_test.h:2,25-27)
    --batch N          query batch (reference is batch 1)
    --quantized-kv     int8 KV with per-token scales
    --seed N

Like the reference it generates random inputs, runs the CPU oracle, runs the
kernel, prints wall time and the max-abs-diff vs the oracle — but asserts a
tolerance instead of leaving pass/fail to eyeballs (SURVEY §4).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-size", type=int, default=512)
    ap.add_argument("--no-kv-parallel", action="store_true")
    ap.add_argument("--kv-splits", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (plain path)")
    ap.add_argument("--tol", type=float, default=2e-2)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from ggml_cuda_experiments_tpu.utils.platform import enable_compile_cache
        enable_compile_cache()
    import numpy as np
    import jax.numpy as jnp

    from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
    from ggml_cuda_experiments_tpu.oracle.attention import attention_ref
    from ggml_cuda_experiments_tpu.oracle.quant import (
        dequantize_int8_rowwise, quantize_int8_rowwise)
    from ggml_cuda_experiments_tpu.utils.device_info import device_summary
    from ggml_cuda_experiments_tpu.utils.harness import diff_report, max_abs_diff

    kv = max(256, args.kv_size)
    print(device_summary())
    print(f"shapes: batch={args.batch} heads={args.heads}/{args.kv_heads} "
          f"head_dim={args.head_dim} kv={kv} "
          f"{'single-pass' if args.no_kv_parallel else f'split-kv x{args.kv_splits}'}"
          f"{' int8-kv' if args.quantized_kv else ''}")

    rng = np.random.default_rng(args.seed)
    q = rng.normal(size=(args.batch, args.heads, args.head_dim)).astype(np.float32)
    k = rng.normal(size=(args.batch, args.kv_heads, kv, args.head_dim)).astype(np.float32)
    v = rng.normal(size=(args.batch, args.kv_heads, kv, args.head_dim)).astype(np.float32)

    kwargs = {}
    if args.quantized_kv:
        kq, ks = quantize_int8_rowwise(k)
        vq, vs = quantize_int8_rowwise(v)
        k_oracle = dequantize_int8_rowwise(kq, ks)
        v_oracle = dequantize_int8_rowwise(vq, vs)
        kd, vd = jnp.asarray(kq), jnp.asarray(vq)
        kwargs = dict(k_scale=jnp.asarray(ks[..., 0]),
                      v_scale=jnp.asarray(vs[..., 0]))
    else:
        k_oracle, v_oracle = k, v
        kd, vd = jnp.asarray(k), jnp.asarray(v)

    t0 = time.perf_counter()
    want = attention_ref(q[:, :, None], k_oracle, v_oracle)[:, :, 0]
    print(f"cpu oracle: {time.perf_counter()-t0:.2f}s")

    splits = 1 if args.no_kv_parallel else args.kv_splits
    fn = lambda: flash_decode(jnp.asarray(q), kd, vd, kv_splits=splits,
                              **kwargs)
    got = np.asarray(fn())                      # compile + run
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"device time: {dt*1e3:.4f} ms")     # ~ "cuda time: %.4f ms"

    mad, idx = max_abs_diff(got, want)
    print(diff_report("flash_decode vs oracle", got, want))
    if mad > args.tol:
        print(f"FAIL: max diff {mad} > tol {args.tol}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
