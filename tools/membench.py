#!/usr/bin/env python
"""Memory-movement microbenchmarks — the analog of the reference's
bandwidth studies (`transpose.cu` GB/s table, /root/reference/src/misc/
transpose.cu:50-220, and `coalescing.cu` offset/stride sweep,
/root/reference/src/misc/coalescing.cu:44-105) asked through XLA: HBM copy,
transpose, the interleave permutation used by the quant kernels, and
bf16<->f32 conversion — each as achieved GB/s against the card's published
HBM peak.

Run: python tools/membench.py [--mb 256]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import numpy as np
import jax.numpy as jnp

from ggml_cuda_experiments_tpu.ops.quant_matmul import permute_activations
from ggml_cuda_experiments_tpu.utils.device_info import chip_spec
from ggml_cuda_experiments_tpu.utils.platform import enable_compile_cache


def marginal(make, n_small=16, n_big=64, reps=5):
    """Best-of-reps marginal time per pass between two chain lengths
    (launch costs cancel)."""
    def run(n):
        f = make(n)
        jax.block_until_ready(f())             # compile + warm
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            best = min(best, time.perf_counter() - t0)
        return best
    return (run(n_big) - run(n_small)) / (n_big - n_small)


def chained(op, x0, n):
    @jax.jit
    def f():
        def body(_, x):
            return op(x)
        return jax.lax.fori_loop(0, n, body, x0)
    return f


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=128)
    ap.add_argument("--strides", action="store_true",
                    help="strided-read sweep (coalescing.cu analog)")
    args = ap.parse_args()
    enable_compile_cache()
    spec = chip_spec()
    peak = spec.hbm_bytes_per_s / 1e9
    print(f"{spec.device_kind}: peak {peak:.0f} GB/s")

    n_elems = args.mb * 1024 * 1024 // 4
    rows = 4096
    cols = n_elems // rows
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(rows, cols)).astype(np.float32))

    cases = {
        # read + write => 2x bytes per pass
        "copy (x+1)": (lambda v: v + 1.0, 2),
        "transpose": (lambda v: v.T.reshape(v.shape) + 0.0, 2),
        "interleave perm": (lambda v: permute_activations(v), 2),
        "f32->bf16->f32": (lambda v: v.astype(jnp.bfloat16)
                           .astype(jnp.float32), 1.5),
        "reduce (sum rows)": (lambda v: v + jnp.sum(v, axis=0,
                                                    keepdims=True), 3),
    }
    for name, (op, factor) in cases.items():
        dt = marginal(lambda n, op=op: chained(op, x, n))
        gbs = x.nbytes * factor / dt / 1e9
        print(f"{name:18s}: {dt*1e3:7.3f} ms/pass  {gbs:7.1f} GB/s "
              f"({100*gbs/peak:5.1f}% peak)")

    if args.strides:
        # coalescing.cu stride sweep analog (/root/reference/src/misc/
        # coalescing.cu:64-105): read every stride-th column. A strided
        # warp reads whole DRAM sectors for a few useful bytes — useful
        # bytes drop while fetched bytes stay the same, and the effective
        # GB/s shows it.
        print("\nstride sweep (useful-bytes GB/s; fetch is whole sectors):")
        for stride in (1, 2, 4, 8, 16, 32):
            def op(v, s=stride):
                y = v[:, ::s]
                return jnp.pad(y + 1.0, ((0, 0), (0, v.shape[1] - y.shape[1])))
            dt = marginal(lambda n, op=op: chained(op, x, n))
            useful = x.nbytes // stride + x.nbytes  # read subset + write full
            gbs = useful / dt / 1e9
            print(f"  stride {stride:2d}: {dt*1e3:7.3f} ms/pass "
                  f"{gbs:7.1f} GB/s ({100*gbs/peak:5.1f}% peak)")


if __name__ == "__main__":
    main()
