#!/usr/bin/env python
"""Continuous-batching engine throughput on the card (config 4 shape).

Measures steady-state generated tokens/s with N concurrent requests through
the full Engine stack (paged pool, page allocator, admission, sampling) —
the serving-side complement to bench.py's jitted-scan decode number.

Usage: python tools/engine_bench.py [--model llama2-7b] [--batch 8]
       [--prompt 64] [--gen 64] [--pages 128] [--int8-kv] [--native-sched]
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--fmt", default="q4_k")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--native-sched", action="store_true")
    ap.add_argument("--window", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill size (exercises the "
                         "all-requests-per-pass chunk dispatch)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="wrap the measured run in jax.profiler.trace, "
                         "written under DIR (e.g. chiprun_out/trace)")
    args = ap.parse_args()

    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models.engine import Engine
    from ggml_cuda_experiments_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    cfg = dataclasses.replace(PRESETS[args.model], x_quant8=True)
    t0 = time.perf_counter()
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=0, as_numpy=True), args.fmt)
    params = jax.device_put(params)
    jax.block_until_ready(jax.tree.leaves(params))
    print(f"params ready in {time.perf_counter()-t0:.0f}s", flush=True)

    rng = np.random.default_rng(0)
    max_seq = args.prompt + args.gen

    def run(n_req):
        eng = Engine(
            params, cfg, max_batch=args.batch, page_size=args.page_size,
            n_pages=args.pages,
            max_seq_len=-(-max_seq // args.page_size) * args.page_size,
            quantized_kv=args.int8_kv,
            scheduler="native" if args.native_sched else "python",
            decode_window=args.window,
            prefill_chunk=args.prefill_chunk)
        for _ in range(n_req):
            eng.add_request(
                rng.integers(0, cfg.vocab_size, size=args.prompt).tolist(),
                max_new_tokens=args.gen)
        t0 = time.perf_counter()
        out = eng.run_to_completion()
        dt = time.perf_counter() - t0
        toks = sum(len(v) for v in out.values())
        return toks, dt

    run(args.batch)                          # compile prefill+decode
    if args.trace:
        from jax import profiler as _profiler
        _profiler.start_trace(args.trace)
    # marginal over request count removes compile/fixed costs
    t_small = run(args.batch)
    t_big = run(args.batch * 3)
    if args.trace:
        _profiler.stop_trace()
        print(f"trace written to {args.trace}", flush=True)
    toks = t_big[0] - t_small[0]
    secs = t_big[1] - t_small[1]
    print(f"{args.model} {args.fmt} engine (batch {args.batch}, "
          f"prompt {args.prompt}, gen {args.gen}"
          f"{', int8 kv' if args.int8_kv else ''}): "
          f"{toks/secs:.1f} generated tok/s steady-state "
          f"({t_big[0]} toks in {t_big[1]:.1f}s total)", flush=True)


if __name__ == "__main__":
    main()
