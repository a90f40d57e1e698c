#!/usr/bin/env python
"""Perplexity / logits parity harness: engine vs the full-model CPU oracle.

BASELINE.md's accuracy gate: "logits/perplexity match CPU llama.cpp-style
reference at same bit-width". This evaluates next-token perplexity of a
(quantized) model with the JAX engine and with the pure-NumPy oracle on the
same token stream, and reports PPL + max logit diff.

Usage:
  python tools/perplexity.py [--model debug|tinyllama-1.1b] [--fmt q4_k]
      [--tokens 512] [--cpu] [--gguf path.gguf]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="debug")
    ap.add_argument("--fmt", default="q4_k")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gguf", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-oracle", action="store_true",
                    help="engine PPL only (oracle is O(T^2) NumPy)")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from ggml_cuda_experiments_tpu.utils.platform import (
            enable_compile_cache)
        enable_compile_cache()

    import numpy as np
    import jax.numpy as jnp
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.oracle import model as oracle_model

    rng = np.random.default_rng(args.seed)
    if args.gguf:
        from ggml_cuda_experiments_tpu.utils.gguf import load_gguf
        params, cfg = load_gguf(args.gguf)
        qparams = params
    else:
        cfg = PRESETS[args.model]
        params = llama.init_weights(cfg, seed=args.seed, as_numpy=True)
        qparams = (llama.quantize_params(params, args.fmt)
                   if args.fmt != "f32" else params)

    T = args.tokens
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, T)).astype(
        np.int32)

    cache = llama.KVCache.create(cfg, args.batch, max(256, T))
    logits_dev, _ = llama.prefill(qparams, cfg, jnp.asarray(tokens), cache,
                                  all_logits=True)
    logits_dev = np.asarray(logits_dev, np.float32)
    ppl_dev = oracle_model.perplexity(logits_dev, tokens)
    print(f"engine  PPL ({args.fmt}): {ppl_dev:.4f}")

    if not args.skip_oracle:
        logits_ref = oracle_model.forward_logits(qparams, cfg, tokens)
        ppl_ref = oracle_model.perplexity(logits_ref, tokens)
        dmax = np.abs(logits_dev - logits_ref).max()
        rel = abs(ppl_dev - ppl_ref) / ppl_ref
        print(f"oracle  PPL ({args.fmt}): {ppl_ref:.4f}")
        print(f"max |logit diff|: {dmax:.4f}   PPL rel diff: {rel:.2%}")


if __name__ == "__main__":
    main()
