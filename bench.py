#!/usr/bin/env python
"""Headline benchmark on one NVIDIA GPU.

    python bench.py                          # q4_k / q8_0 matvec % of HBM peak
    python bench.py --decode [--model=NAME]  # end-to-end greedy decode tok/s

Prints the device, the card's name and power limit (``nvidia-smi``), and
context lines on stderr, then ONE JSON line on stdout: {"metric", "value",
"unit", "vs_baseline"}. The matvec mode divides by 85% of the card's
published HBM bandwidth (BASELINE.json's target); the decode mode by 85% of
the model's weight-stream bound (every decoded token reads all weights).

Method: a jitted fori_loop chains the fused matvec (decode shape x [1, 4096]
against W [N, 4096]^T, folded back to [1, 4096] so the loop is closed), so
every iteration re-reads the quantized weight from HBM. The rate is the SIZE
marginal between N=32768 and N=8192 weights, timed as interleaved pairs:
launch and fold costs cancel, leaving the kernel's streaming rate.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax
import jax.numpy as jnp
import numpy as np

from ggml_cuda_experiments_tpu.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu.utils.device_info import chip_spec, device_summary
from ggml_cuda_experiments_tpu.utils.platform import enable_compile_cache

K = 4096          # 7B model dim
N_SMALL = 8192    # size-marginal pair for roofline_pct
N_BIG = 32768
INNER = 512


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else "nvidia-smi failed"


def make_chained(inner, ql, **kw):
    @jax.jit
    def chained(x):
        def body(_, x):
            y = qm.qmatmul(x, ql, **kw)
            return (y[:, :K] * 0.03 + y[:, K:2 * K] * 0.03
                    ).astype(jnp.float32)
        return jax.lax.fori_loop(0, inner, body, x)
    return chained


def _time_once(f, x0) -> float:
    t0 = time.perf_counter()
    jax.block_until_ready(f(x0))
    return time.perf_counter() - t0


def roofline_pct(fmt, inner=INNER, n_pairs=7, **kw) -> float:
    """% of peak HBM bandwidth as the size-marginal rate (module
    docstring); the median of ``n_pairs`` interleaved (small, big) pairs."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(N_BIG, K)) / np.sqrt(K)).astype(np.float32)
    x0 = jnp.asarray(rng.normal(size=(1, K)).astype(np.float32))
    fs, nbytes = {}, {}
    for rows in (N_SMALL, N_BIG):
        ql = qm.quantize(w[:rows], fmt)
        fs[rows] = make_chained(inner, ql, **kw)
        nbytes[rows] = ql.nbytes
        jax.block_until_ready(fs[rows](x0))         # compile + warm
    peak_gbs = chip_spec().hbm_bytes_per_s / 1e9
    dbytes = nbytes[N_BIG] - nbytes[N_SMALL]
    pcts = []
    for _ in range(n_pairs):
        t_s = _time_once(fs[N_SMALL], x0)
        t_l = _time_once(fs[N_BIG], x0)
        pcts.append(100.0 * dbytes / ((t_l - t_s) / inner) / 1e9 / peak_gbs)
    pcts.sort()
    pct = pcts[len(pcts) // 2]
    log(f"{fmt}: {pct / 100 * peak_gbs:.1f} GB/s of {peak_gbs:.0f} "
        f"({pct:.1f}% of HBM peak), pairs {[round(p, 1) for p in pcts]}")
    return pct


def decode_bench(model: str, fmt: str = "q4_k", steps_a: int = 8,
                 steps_b: int = 40) -> tuple[float, int]:
    """Greedy decode tokens/s at batch 1: the step-marginal between two
    fully-jitted ``generate_scan`` runs removes prefill and dispatch.
    Also logs TTFT (512-token prompt) and batch-8 throughput."""
    import dataclasses
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models.config import PRESETS

    cfg = dataclasses.replace(PRESETS[model],
                              x_quant8="--exact" not in sys.argv)
    t0 = time.perf_counter()
    log(f"building {model} {fmt} ({cfg.num_params()/1e9:.2f}B params)...")
    params = llama.init_weights(cfg, seed=0, as_numpy=True)
    params = llama.quantize_params(params, fmt)
    params = jax.device_put(params)
    jax.block_until_ready(params)
    log(f"  quantized and transferred in {time.perf_counter()-t0:.0f}s")

    def run(steps, batch=1, plen=16):
        cache = llama.KVCache.create(cfg, batch, 2048)
        p = jnp.ones((batch, plen), jnp.int32)
        t0 = time.perf_counter()
        jax.block_until_ready(llama.generate_scan(params, cfg, p, cache,
                                                  steps))
        return time.perf_counter() - t0

    # bytes one decode step reads: every layer's weights plus the head and
    # final norm (the embed table contributes one row, not a stream)
    stream_bytes = sum(getattr(l, "nbytes", 0) for l in jax.tree.leaves(
        [params["layers"], params["lm_head"], params["final_norm"]]))
    log(f"  weight stream: {stream_bytes/1e9:.2f} GB/token")

    run(steps_a)                                    # compile both
    run(steps_b)
    ta = min(run(steps_a) for _ in range(2))
    tb = min(run(steps_b) for _ in range(2))
    tok_s = (steps_b - steps_a) / (tb - ta)
    log(f"{model} {fmt} decode: {tok_s:.1f} tok/s "
        f"({(tb-ta)/(steps_b-steps_a)*1e3:.2f} ms/token, batch 1)")
    ttfts = sorted(run(1, batch=1, plen=512) for _ in range(5))
    log(f"{model} {fmt} TTFT (512-token prompt, p50): "
        f"{ttfts[len(ttfts)//2]*1e3:.1f} ms")
    t8a = min(run(steps_a, batch=8) for _ in range(2))
    t8b = min(run(steps_b, batch=8) for _ in range(2))
    step8 = (t8b - t8a) / (steps_b - steps_a)
    log(f"{model} {fmt} decode batch 8: {8 / step8:.1f} tok/s total "
        f"({step8*1e3:.2f} ms/step)")
    return tok_s, stream_bytes


def main() -> None:
    enable_compile_cache()
    log(device_summary())
    log(f"card: {nvidia_smi()}")
    spec = chip_spec()
    if "--decode" in sys.argv:
        model = "llama2-7b"
        for a in sys.argv:
            if a.startswith("--model="):
                model = a.split("=", 1)[1]
        tok_s, stream_bytes = decode_bench(model)
        target = 0.85 * spec.hbm_bytes_per_s / stream_bytes
        log(f"decode target: 0.85 * weight-stream bound = {target:.1f} tok/s")
        print(json.dumps({
            "metric": f"{model} q4_k decode throughput (batch 1)",
            "value": round(tok_s, 2),
            "unit": "tokens/s",
            "vs_baseline": round(tok_s / target, 4),
        }))
        return
    q8 = roofline_pct("q8_0")
    pct = roofline_pct("q4_k", x_quant8=True)
    log(f"q4_k median: {pct:.1f}% (q8_0: {q8:.1f}%)")
    print(json.dumps({
        "metric": f"q4_k dequant-matvec HBM roofline ({spec.device_kind})",
        "value": round(pct, 2),
        "unit": "% of peak HBM BW",
        "vs_baseline": round(pct / 85.0, 4),
    }))


if __name__ == "__main__":
    main()
