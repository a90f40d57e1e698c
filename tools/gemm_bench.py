#!/usr/bin/env python
"""Tensor-core GEMM throughput of XLA (cuBLAS) on the card — the achievable
reference beside the reference's WMMA GEMM latency/TFLOPS rigs (HMMA fp16 +
IMMA int8, /root/reference/src/misc/tensor-core.cu:41-73,507-589, and the
CTA-tiled TFLOPS print, /root/reference/src/misc/cudaTensorCoreGemm.cu:
406-407).

Measures XLA dot bf16->f32 (HMMA analog) and int8->int32 (IMMA analog) as
TFLOP/s and % of the card's published peak. Timing: the marginal of two
chain lengths of a jitted fori_loop, so launch costs cancel.

Run: python tools/gemm_bench.py [--sizes 2048,4096,8192]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from ggml_cuda_experiments_tpu.utils.device_info import chip_spec
from ggml_cuda_experiments_tpu.utils.platform import enable_compile_cache


def chained_gemm(mm, a, b, inner):
    @jax.jit
    def f():
        def body(_, a):
            c = mm(a, b)
            # fold output back to input dtype/shape: keeps the loop closed
            # with a cheap elementwise op (cancels in the marginal)
            return (c[:, :a.shape[1]] * 1e-3).astype(a.dtype)
        return jax.lax.fori_loop(0, inner, body, a)
    return f


def measure(mm, a, b, flops, inner_small=4, inner_big=16, reps=5):
    ts = {}
    for inner in (inner_small, inner_big):
        f = chained_gemm(mm, a, b, inner)
        jax.block_until_ready(f())               # compile + warm
        ts[inner] = min(_timed(f) for _ in range(reps))
    per = (ts[inner_big] - ts[inner_small]) / (inner_big - inner_small)
    return per, flops / per


def _timed(f):
    t0 = time.perf_counter()
    jax.block_until_ready(f())
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2048,4096,8192")
    args = ap.parse_args()
    enable_compile_cache()
    spec = chip_spec()
    peak = spec.peak_flops_bf16
    print(f"{spec.device_kind}: peak {peak/1e12:.0f} TFLOP/s bf16, "
          f"{spec.peak_ops_int8/1e12:.0f} TOP/s int8")

    rng = np.random.default_rng(0)
    for n in (int(s) for s in args.sizes.split(",")):
        a16 = jnp.asarray(rng.normal(size=(n, n)), jnp.bfloat16)
        b16 = jnp.asarray(rng.normal(size=(n, n)), jnp.bfloat16)
        a8 = jnp.asarray(rng.integers(-127, 127, (n, n)), jnp.int8)
        b8 = jnp.asarray(rng.integers(-127, 127, (n, n)), jnp.int8)
        flops = 2.0 * n ** 3
        cases = {
            f"XLA dot bf16 {n}^3": (
                lambda a, b: jax.lax.dot(a, b,
                                         preferred_element_type=jnp.float32),
                a16, b16, peak),
            f"XLA dot int8 {n}^3": (
                lambda a, b: jax.lax.dot(a, b,
                                         preferred_element_type=jnp.int32),
                a8, b8, spec.peak_ops_int8),
        }
        for name, (mm, a, b, pk) in cases.items():
            per, fps = measure(mm, a, b, flops)
            print(f"{name:24s}: {per*1e3:8.3f} ms  "
                  f"{fps/1e12:7.2f} TFLOP/s  ({100*fps/pk:5.1f}% of peak)")


if __name__ == "__main__":
    main()
