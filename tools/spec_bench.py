#!/usr/bin/env python
"""Speculative decoding measurement on the card.

Measures the fully-on-device speculative window
(models/speculative.py::speculative_scan — draft scan + one verify pass +
accept/rewind, zero host syncs) against plain scan decode:

  - per-window device cost (marginal between two window counts, host-fetch
    forced, same methodology as bench.py);
  - tokens/window at a given acceptance; with random-init weights TRUE
    cross-model acceptance is meaningless (~chance), so the tool reports
    the draft==target upper bound (acceptance 1: mechanics overhead only)
    and the measured window cost with a REAL small draft, from which the
    break-even acceptance rate vs plain decode follows:

      speedup(a) = (E[accepted|a] + 1) * t_plain / t_window,
      E[accepted|a] = sum_{i=1..gamma} a^i  (leading-accept model)

Usage: python tools/spec_bench.py [--target llama2-7b]
       [--draft tinyllama-1.1b] [--gamma 4] [--windows 16]
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load(model, fmt="q4_k"):
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.models import llama

    cfg = dataclasses.replace(PRESETS[model], x_quant8=True)
    t0 = time.perf_counter()
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=0, as_numpy=True), fmt)
    params = jax.device_put(params)
    jax.block_until_ready(jax.tree.leaves(params))
    log(f"{model} ready in {time.perf_counter()-t0:.0f}s")
    return params, cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="llama2-7b")
    ap.add_argument("--draft", default="tinyllama-1.1b")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="build the draft by truncating the TARGET "
                         "checkpoint to its first K layers (shared embed/"
                         "norm/head; an offline-constructible draft whose "
                         "agreement with the target is real and "
                         "measurable). Also measures "
                         "teacher-forced acceptance before the end-to-end "
                         "window bench.")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--w-small", type=int, default=4)
    ap.add_argument("--w-big", type=int, default=16)
    ap.add_argument("--plen", type=int, default=16)
    args = ap.parse_args()

    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models import speculative as spec

    tparams, tcfg = load(args.target)
    if args.draft_layers:
        k = args.draft_layers
        dcfg = dataclasses.replace(tcfg, n_layers=k)
        dparams = {"embed": tparams["embed"],
                   "layers": tparams["layers"][:k],
                   "final_norm": tparams["final_norm"],
                   "lm_head": tparams["lm_head"]}
        draft_name = f"target[:{k} layers]"
    else:
        dparams, dcfg = load(args.draft)
        draft_name = args.draft
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, min(tcfg.vocab_size,
                                             dcfg.vocab_size),
                                      (1, args.plen)), jnp.int32)
    gamma = args.gamma
    max_len = 1024

    def run_windows(windows, dp, dc):
        tcache = llama.KVCache.create(tcfg, 1, max_len)
        dcache = llama.KVCache.create(dc, 1, max_len)
        tl, tcache = llama.prefill(tparams, tcfg, prompt, tcache)
        _, dcache = llama.prefill(dp, dc, prompt, dcache)
        cur = jnp.argmax(tl, -1).astype(jnp.int32)
        t0 = time.perf_counter()
        toks, counts, *_ = spec.speculative_scan(
            tparams, tcfg, dp, dc, cur, tcache, dcache,
            gamma=gamma, windows=windows)
        counts = np.asarray(counts)          # fetch forces completion
        np.asarray(toks)
        return time.perf_counter() - t0, counts

    def plain(steps):
        cache = llama.KVCache.create(tcfg, 1, max_len)
        t0 = time.perf_counter()
        toks = llama.generate_scan(tparams, tcfg, prompt, cache, steps)
        np.asarray(toks)
        return time.perf_counter() - t0

    # teacher-forced acceptance of the truncated draft: generate the
    # target's greedy sequence, then ONE all-logits draft pass over it —
    # acceptance = P(draft argmax == target's next token | true prefix),
    # exactly the per-position accept probability of greedy speculation
    if args.draft_layers:
        n_eval = 192
        cache = llama.KVCache.create(tcfg, 1, max_len)
        seq = llama.generate_scan(tparams, tcfg, prompt, cache, n_eval)
        seq = np.asarray(seq)                       # [1, n_eval]
        full = np.concatenate([np.asarray(prompt), seq], axis=1)
        T = full.shape[1] - 1
        Tp = -(-T // 128) * 128
        padded = np.pad(full[:, :-1], ((0, 0), (0, Tp - T)))
        dcache = llama.KVCache.create(dcfg, 1, max(max_len, Tp))
        dlogits, _ = llama.prefill(dparams, dcfg, jnp.asarray(padded),
                                   dcache, all_logits=True)
        dpred = np.asarray(jnp.argmax(dlogits[0, :T], -1))
        want = full[0, 1:]
        # score only generated positions (after the random prompt)
        gen0 = args.plen - 1
        acc_tf = float((dpred[gen0:] == want[gen0:]).mean())
        log(f"teacher-forced acceptance of {draft_name}: {acc_tf:.3f} "
            f"over {T-gen0} generated positions "
            f"(draft cost ~{args.draft_layers}/{tcfg.n_layers} of target)")

    # plain decode marginal
    plain(8); plain(40)
    pa = min(plain(8) for _ in range(2))
    pb = min(plain(40) for _ in range(2))
    t_plain = (pb - pa) / 32
    log(f"plain decode: {t_plain*1e3:.2f} ms/token "
        f"({1/t_plain:.1f} tok/s)")

    for name, dp, dc in (("draft=target (acc=1 bound)", tparams, tcfg),
                         (f"draft={draft_name}", dparams, dcfg)):
        run_windows(args.w_small, dp, dc)     # compile
        run_windows(args.w_big, dp, dc)
        ta, ca = min((run_windows(args.w_small, dp, dc)
                      for _ in range(2)), key=lambda x: x[0])
        tb, cb = min((run_windows(args.w_big, dp, dc)
                      for _ in range(2)), key=lambda x: x[0])
        t_win = (tb - ta) / (args.w_big - args.w_small)
        toks_win = cb.mean()
        acc = (cb.mean() - 1) / gamma
        speedup = toks_win * t_plain / t_win
        log(f"{name}: {t_win*1e3:.2f} ms/window, {toks_win:.2f} tok/window "
            f"(acceptance {acc:.2f}), tok/s {toks_win/t_win:.1f} "
            f"= {speedup:.2f}x plain")
        if dp is tparams:
            # break-even: acceptance a* where speedup == 1
            for a in np.linspace(0, 1, 101):
                exp_tok = sum(a ** i for i in range(1, gamma + 1)) + 1
                if exp_tok * t_plain >= t_win:
                    log(f"  break-even acceptance (gamma={gamma}): "
                        f"~{a:.2f} (window cost {t_win/t_plain:.2f}x a "
                        f"plain token)")
                    break


if __name__ == "__main__":
    main()
