#!/usr/bin/env python
"""Bring-up check of the whole system on one NVIDIA GPU.

    python chip_smoke.py                 # one card: phases 1-4
    python chip_smoke.py --four-cards    # tensor-parallel engine on 4 cards

Phases, in order; the first that fails ends the run with a non-zero exit:

1. device   — requires a GPU; prints device kind and count, jax/jaxlib,
               XLA_FLAGS, and the card's name and power limit.
2. kernels  — every kernel-backed op at Llama-2-7B widths, compiled for
               the card: its chosen implementation, its error against the
               NumPy reference, and for each hand-written kernel its time
               beside the plain XLA path's (interleaved kernel, XLA, XLA,
               kernel) and its compiled memory analysis.
3. model    — Llama-2-7B, full width and depth, random q4_k weights from a
               seed: prefill (TTFT), B=1 and B=8 greedy decode through
               ``generate_scan``, teacher-forced logits against the
               kernel-free plain path, and a depth-2 cut against the NumPy
               model oracle.
4. serving  — the continuous-batching Engine serving mixed-length requests
               with the int8 page pool, then the bf16 pool; the bf16
               pool's per-step logits against the contiguous-cache model.

The last line of standard output is one JSON object with ``"ok": true`` and
the device as JAX reports it. Times are the card's; they vary with its
power limit, which phase 1 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


class Failed(Exception):
    """A phase's check failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def nvidia_smi() -> str:
    """Card name and power limit, from a child process that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if r.returncode != 0:
        raise Failed(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def per_op(fns: dict, shared: tuple, own: tuple, n_big: int = 6,
           n_small: int = 2, reps: int = 3) -> dict:
    """Seconds per call of each implementation in ``fns`` (name -> fn),
    all called as ``fn(*shared, *own)``.

    One jitted call runs the op on ``n_big`` (or ``n_small``) distinct
    device copies of the ``own`` operands (weights, caches), so XLA can
    neither hoist a loop-invariant dequantization nor fuse repeats, and
    every call reads its operands from device memory. The time per op is
    the marginal between the two counts (launch costs cancel). The
    implementations are interleaved as a, b, b, a within each repeat."""
    import jax
    import jax.numpy as jnp
    copies = [jax.tree.map(jnp.copy, own) for _ in range(n_big)]
    runs = {}
    for name, fn in fns.items():
        f = jax.jit(lambda sh, cs, fn=fn: [fn(*sh, *c) for c in cs])
        for cs in (copies, copies[:n_small]):
            jax.block_until_ready(f(shared, cs))        # compile + warm
        runs[name] = f
    best = {name: [float("inf")] * 2 for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(reps):
        for name in order:
            for i, cs in enumerate((copies, copies[:n_small])):
                t = time.perf_counter()
                jax.block_until_ready(runs[name](shared, cs))
                best[name][i] = min(best[name][i], time.perf_counter() - t)
    del copies
    return {name: (b - s) / (n_big - n_small) for name, (b, s) in
            best.items()}


def memory_line(fn, args) -> str:
    import jax
    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    if ma is None:
        return "memory_analysis: n/a"
    return (f"memory_analysis: args {ma.argument_size_in_bytes/2**20:.1f} MiB,"
            f" out {ma.output_size_in_bytes/2**20:.1f} MiB,"
            f" temp {ma.temp_size_in_bytes/2**20:.1f} MiB")


def rel_err(got, want) -> float:
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# phase 2: kernels at Llama-2-7B widths
# ---------------------------------------------------------------------------

# bf16 operands keep ~3 significant digits; over K-long sums of random
# signs the worst element of a product drifts by ~1% of the largest.
TOL_MATVEC = 2e-2
# attention: bf16 q/K/V operands and bf16 probabilities in the P.V dot.
TOL_ATTN = 2e-2


def phase_kernels(report: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ggml_cuda_experiments_tpu.models.llama import _quantize_rowwise
    from ggml_cuda_experiments_tpu.ops import attention as attn_mod
    from ggml_cuda_experiments_tpu.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
    from ggml_cuda_experiments_tpu.ops.paged_attention import paged_decode
    from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
    from ggml_cuda_experiments_tpu.oracle.attention import attention_ref
    from ggml_cuda_experiments_tpu.utils import native
    from ggml_cuda_experiments_tpu.utils.device_info import chip_spec
    from ggml_cuda_experiments_tpu.ops.flash_decode import (
        choose_impl as flash_decode_impl)
    from ggml_cuda_experiments_tpu.ops.paged_attention import (
        choose_impl as paged_decode_impl)

    # -- card-only tests first: each kernel compiled small (tests/test_on_card.py)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_on_card", ROOT / "tests" / "test_on_card.py")
    tmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tmod)
    for name in sorted(n for n in dir(tmod) if n.startswith("test_")):
        getattr(tmod, name)(np.random.default_rng(SEED), None)
        log(f"card test {name}: passed")

    rng = np.random.default_rng(SEED)
    rows = []
    report["kernels"] = rows

    def emit(row, ok=True, what=""):
        log(json.dumps(row))
        rows.append(row)
        check(ok, what or json.dumps(row))

    def qfns(**kw):
        return {"kernel": lambda x, w: qm.qmatmul(x, w, impl="kernel", **kw),
                "xla": lambda x, w: qm.qmatmul(x, w, impl="xla", **kw)}

    # -- dequant matvec: every 7B linear, B=1 / B=8 / T=512 ---------------
    shapes = {"wqkv (12288x4096)": (12288, 4096),
              "wo (4096x4096)": (4096, 4096),
              "w_gu (22016x4096)": (22016, 4096),
              "w_down (4096x11008)": (4096, 11008),
              "lm_head (32000x4096)": (32000, 4096)}
    for name, (n, k) in shapes.items():
        w = (rng.standard_normal((n, k), np.float32) / np.sqrt(k))
        t = native.quantize(w, "q4_k")
        ql = qm.from_oracle(t)
        deq = quant_ref.dequantize_q4_k(t)
        for b in (1, 8, 512):
            xj = jnp.asarray(rng.standard_normal((b, k), np.float32),
                             jnp.bfloat16)
            impl = qm.choose_impl(ql, b)
            got = qm.qmatmul(xj, ql, out_dtype=jnp.float32)
            err = rel_err(got, np.asarray(xj, np.float32) @ deq.T)
            row = dict(op="qmatmul q4_k", shape=name, rows=b, impl=impl,
                       rel_err=err, tol=TOL_MATVEC, bytes=ql.nbytes)
            if b <= 16:
                ts = per_op(qfns(), (xj,), (ql,))
                row.update(kernel_us=ts["kernel"] * 1e6,
                           xla_us=ts["xla"] * 1e6,
                           kernel_GBps=ql.nbytes / ts["kernel"] / 1e9,
                           xla_GBps=ql.nbytes / ts["xla"] / 1e9,
                           mem=memory_line(qfns()["kernel"], (xj, ql)))
            emit(row, err < TOL_MATVEC)

    # the two other kernel formats, x_quant8, and where XLA takes over
    n, k = 22016, 4096
    w = (rng.standard_normal((n, k), np.float32) / np.sqrt(k))
    for fmt in ("q8_0", "q4_0", "q4_k"):
        t = native.quantize(w, fmt)
        ql = qm.from_oracle(t)
        deq = quant_ref.FORMATS[fmt][1](t)
        for b in (1, 16, 32) if fmt == "q4_k" else (1,):
            x = jnp.asarray(rng.standard_normal((b, k), np.float32),
                            jnp.bfloat16)
            got = qm.qmatmul(x, ql, impl="kernel", out_dtype=jnp.float32)
            err = rel_err(got, np.asarray(x, np.float32) @ deq.T)
            ts = per_op(qfns(), (x,), (ql,))
            emit(dict(op=f"qmatmul {fmt}", shape=f"{n}x{k}", rows=b,
                      impl="kernel", rel_err=err, tol=TOL_MATVEC,
                      kernel_us=ts["kernel"] * 1e6, xla_us=ts["xla"] * 1e6),
                 err < TOL_MATVEC)
    x = jnp.asarray(rng.standard_normal((1, k), np.float32), jnp.bfloat16)
    ts = per_op(qfns(x_quant8=True), (x,), (ql,))
    emit(dict(op="qmatmul q4_k x_quant8", shape=f"{n}x{k}", rows=1,
              kernel_us=ts["kernel"] * 1e6, xla_us=ts["xla"] * 1e6))

    # w_down as stored (K=11008) vs padded to a multiple of 4096
    for kk in (11008, 12288):
        wd = np.zeros((4096, kk), np.float32)
        wd[:, :11008] = rng.standard_normal((4096, 11008), np.float32) / 105
        ql = qm.quantize(wd, "q4_k")
        x = jnp.asarray(rng.standard_normal((1, kk), np.float32),
                        jnp.bfloat16)
        ts = per_op(qfns(), (x,), (ql,))
        emit(dict(op="qmatmul q4_k w_down K", shape=f"4096x{kk}", rows=1,
                  kernel_us=ts["kernel"] * 1e6, xla_us=ts["xla"] * 1e6,
                  bytes=ql.nbytes))

    # q6_k head (plain path only): time against its byte floor
    wq6 = rng.standard_normal((32000, 4096), np.float32) / 64
    t6 = native.quantize(wq6, "q6_k")
    ql6 = qm.from_oracle(t6)
    x = jnp.asarray(rng.standard_normal((1, 4096), np.float32), jnp.bfloat16)
    ts = per_op({"xla": lambda x, w: qm.qmatmul(x, w)}, (x,), (ql6,))
    got = qm.qmatmul(x, ql6, out_dtype=jnp.float32)
    err = rel_err(got, np.asarray(x, np.float32)
                  @ quant_ref.dequantize_q6_k(t6).T)
    floor = ql6.nbytes / chip_spec().hbm_bytes_per_s
    emit(dict(op="qmatmul q6_k head", shape="32000x4096", rows=1,
              impl=qm.choose_impl(ql6, 1), xla_us=ts["xla"] * 1e6,
              byte_floor_us=floor * 1e6, bytes=ql6.nbytes, rel_err=err,
              tol=TOL_MATVEC), err < TOL_MATVEC)

    # -- decode attention: S=4096, D=128, bf16 / int8 / fp8 K/V -----------
    S, D = 4096, 128
    for hq, hkv in ((32, 32), (32, 8)):
        for b, lens in ((1, [4096]), (8, [4096, 17, 1000, 2048, 64, 3000,
                                          4095, 512])):
            q = jnp.asarray(rng.standard_normal((b, hq, D), np.float32),
                            jnp.bfloat16)
            kf32 = rng.standard_normal((2, b, hkv, S, D), np.float32)
            vf32 = rng.standard_normal((2, b, hkv, S, D), np.float32)
            lengths = jnp.asarray(lens, jnp.int32)
            for kv in ("bf16", "int8", "fp8"):
                if kv == "bf16":
                    k = jnp.asarray(kf32, jnp.bfloat16)
                    v = jnp.asarray(vf32, jnp.bfloat16)
                    ks = vs = None
                    kd, vd = np.asarray(k[1], np.float32), np.asarray(
                        v[1], np.float32)
                else:
                    k, ks = _quantize_rowwise(jnp.asarray(kf32), kv)
                    v, vs = _quantize_rowwise(jnp.asarray(vf32), kv)
                    kd = np.asarray(k[1], np.float32) * np.asarray(
                        ks[1])[..., None]
                    vd = np.asarray(v[1], np.float32) * np.asarray(
                        vs[1])[..., None]
                mask = np.where(np.arange(S)[None, None, None, :]
                                < np.asarray(lens)[:, None, None, None],
                                0.0, -np.inf).astype(np.float32)
                want = attention_ref(np.asarray(q, np.float32)[:, :, None],
                                     kd, vd, mask=mask)[:, :, 0]
                got = flash_decode(q, k, v, lengths, k_scale=ks, v_scale=vs,
                                   layer=1)
                err = rel_err(got, want)
                fns = {i: (lambda q, l, k, v, ks, vs, i=i: flash_decode(
                    q, k, v, l, k_scale=ks, v_scale=vs, layer=1, impl=i))
                    for i in ("kernel", "xla")}
                ts = per_op(fns, (q, lengths), (k, v, ks, vs), n_big=4,
                            n_small=1)
                row = dict(op="flash_decode", heads=f"{hq}/{hkv}", kv=kv,
                           batch=b, S=S, impl=flash_decode_impl(),
                           rel_err=err, tol=TOL_ATTN,
                           kernel_us=ts["kernel"] * 1e6,
                           xla_us=ts["xla"] * 1e6)
                if kv == "bf16":
                    row["mem"] = memory_line(fns["kernel"],
                                             (q, lengths, k, v, ks, vs))
                emit(row, err < TOL_ATTN)
                del k, v, ks, vs

    # -- paged decode: page size 64, 7B heads, B=8 -------------------------
    ps, pps, b, hq, hkv = 64, 64, 8, 32, 32
    npg = b * pps + 1
    lens = [4096, 17, 1000, 1500, 64, 777, 4095, 300]
    pidx = rng.permutation(npg - 1)[: b * pps].reshape(b, pps).astype(
        np.int32)
    q = jnp.asarray(rng.standard_normal((b, hq, D), np.float32),
                    jnp.bfloat16)
    kp32 = rng.standard_normal((2, npg, hkv, ps, D), np.float32)
    vp32 = rng.standard_normal((2, npg, hkv, ps, D), np.float32)
    for kv in ("bf16", "int8"):
        if kv == "bf16":
            kp, vp = jnp.asarray(kp32, jnp.bfloat16), jnp.asarray(
                vp32, jnp.bfloat16)
            ks = vs = None
            kdp, vdp = np.asarray(kp[1], np.float32), np.asarray(
                vp[1], np.float32)
        else:
            kp, ks = _quantize_rowwise(jnp.asarray(kp32))
            vp, vs = _quantize_rowwise(jnp.asarray(vp32))
            kdp = np.asarray(kp[1], np.float32) * np.asarray(ks[1])[..., None]
            vdp = np.asarray(vp[1], np.float32) * np.asarray(vs[1])[..., None]
        # contiguous reference cache gathered on the host
        kc = kdp[pidx].transpose(0, 2, 1, 3, 4).reshape(b, hkv, pps * ps, D)
        vc = vdp[pidx].transpose(0, 2, 1, 3, 4).reshape(b, hkv, pps * ps, D)
        mask = np.where(np.arange(pps * ps)[None, None, None, :]
                        < np.asarray(lens)[:, None, None, None],
                        0.0, -np.inf).astype(np.float32)
        want = attention_ref(np.asarray(q, np.float32)[:, :, None], kc, vc,
                             mask=mask)[:, :, 0]
        lj, pj = jnp.asarray(lens, jnp.int32), jnp.asarray(pidx)
        got = paged_decode(q, kp, vp, lj, pj, k_scale_pages=ks,
                           v_scale_pages=vs, layer=1)
        err = rel_err(got, want)
        fns = {i: (lambda q, l, p, k, v, ks, vs, i=i: paged_decode(
            q, k, v, l, p, k_scale_pages=ks, v_scale_pages=vs, layer=1,
            impl=i)) for i in ("kernel", "xla")}
        ts = per_op(fns, (q, lj, pj), (kp, vp, ks, vs), n_big=4, n_small=1)
        emit(dict(op="paged_decode", heads=f"{hq}/{hkv}", kv=kv, batch=b,
                  page_size=ps, impl=paged_decode_impl(), rel_err=err,
                  tol=TOL_ATTN, kernel_us=ts["kernel"] * 1e6,
                  xla_us=ts["xla"] * 1e6,
                  mem=memory_line(fns["kernel"],
                                  (q, lj, pj, kp, vp, ks, vs))),
             err < TOL_ATTN)

    # -- prefill attention T=512: cuDNN vs the plain path ------------------
    T = 512
    for hq, hkv in ((32, 32), (32, 8)):
        q, k, v = (jnp.asarray(rng.standard_normal((1, h, T, D), np.float32),
                               jnp.bfloat16) for h in (hq, hkv, hkv))
        want = attention_ref(*(np.asarray(a, np.float32) for a in (q, k, v)),
                             causal=True)
        impl = attn_mod.choose_impl(q, k, causal=True)
        got = attn_mod.attention(q, k, v, causal=True)
        err = rel_err(got, want)
        fns = {i: (lambda q, k, v, i=i: attn_mod.attention(
            q, k, v, causal=True, impl=i)) for i in ("cudnn", "xla")}
        ts = per_op(fns, (), (q, k, v))
        emit(dict(op="attention prefill", heads=f"{hq}/{hkv}", T=T,
                  impl=impl, rel_err=err, tol=TOL_ATTN,
                  cudnn_us=ts["cudnn"] * 1e6, xla_us=ts["xla"] * 1e6),
             err < TOL_ATTN)


# ---------------------------------------------------------------------------
# phase 3: Llama-2-7B
# ---------------------------------------------------------------------------

# Teacher-forced logits, kernels vs the kernel-free plain path at highest
# matmul precision. Both carry bf16 activations through 32 layers of random
# weights; the kernels' other summation order and bf16 dot operands move
# each logit by a few bf16 ulps of the activations.
TOL_LOGITS = 5e-2
# Depth-2 cut vs the NumPy f32 oracle: adds the device's bf16 Q4_K-E
# effective scales (~0.4% per weight) and bf16 activations.
TOL_ORACLE = 5e-2


def _to_device(tree):
    import jax
    import jax.numpy as jnp
    import numpy as np
    return jax.tree.map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree)


def phase_model(report: dict, depth: int | None, state: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu.oracle import model as om
    from ggml_cuda_experiments_tpu.utils import native

    cfg = PRESETS["llama2-7b"]
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    check(native.available(), "native quant codec did not build")
    r = report.setdefault("model", {})
    t0 = time.perf_counter()
    host = llama.init_weights(cfg, seed=SEED, as_numpy=True)
    r["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = _to_device(llama.quantize_params(host, "q4_k"))
    jax.block_until_ready(params)
    r["quantize_transfer_s"] = time.perf_counter() - t0
    cut = {"embed": host["embed"], "final_norm": host["final_norm"],
           "lm_head": host["lm_head"], "layers": host["layers"][:2]}
    del host
    log(f"model {cfg.name} depth {cfg.n_layers}: init {r['init_s']:.1f} s,"
        f" quantize+transfer {r['quantize_transfer_s']:.1f} s")
    dev = jax.devices()[0]

    rng = np.random.default_rng(SEED)
    T, S, steps, n_tf = 512, 2048, 32, 8
    plain = dataclasses.replace(cfg, impl="xla")
    r["runs"] = {}
    for B in (1, 8):
        prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T)),
                             jnp.int32)
        run = r["runs"][f"B{B}"] = {}
        cache0 = llama.KVCache.create(cfg, B, S)
        t0 = time.perf_counter()
        prefill_c = llama.prefill.lower(params, cfg, prompt, cache0).compile()
        gen_c = llama.generate_scan.lower(params, cfg, prompt, cache0,
                                          steps=steps).compile()
        run["compile_s"] = time.perf_counter() - t0
        ttfts = []
        for _ in range(3):
            cache = llama.KVCache.create(cfg, B, S)
            t0 = time.perf_counter()
            logits, cache = prefill_c(params, prompt, cache)
            jax.block_until_ready(logits)
            ttfts.append(time.perf_counter() - t0)
        run["ttft_ms"] = min(ttfts) * 1e3
        gens = []
        for _ in range(2):
            cache = llama.KVCache.create(cfg, B, S)
            t0 = time.perf_counter()
            toks = np.asarray(gen_c(params, prompt, cache))
            gens.append(time.perf_counter() - t0)
        check(toks.shape == (B, steps), f"generate_scan shape {toks.shape}")
        dec = (min(gens) - min(ttfts)) / steps
        run["decode_ms_per_step"] = dec * 1e3
        run["decode_tok_s"] = B / dec
        log(f"B={B}: compile {run['compile_s']:.1f} s, TTFT(T={T}) "
            f"{run['ttft_ms']:.2f} ms, decode {run['decode_ms_per_step']:.3f}"
            f" ms/step = {run['decode_tok_s']:.1f} tok/s")

        # teacher forcing: the generated tokens drive both paths
        forced = jnp.asarray(toks[:, :n_tf])

        def tf_logits(c):
            cache = llama.KVCache.create(c, B, S)
            if c is cfg:
                lg, cache = prefill_c(params, prompt, cache)
            else:
                lg, cache = llama.prefill(params, c, prompt, cache)
            out = [np.asarray(lg)]
            for i in range(n_tf - 1):
                lg, cache = llama.decode_step(params, c, forced[:, i], cache)
                out.append(np.asarray(lg))
            return np.stack(out, 1)                  # [B, n_tf, V]

        t0 = time.perf_counter()
        got = tf_logits(cfg)
        with jax.default_matmul_precision("highest"):
            want = tf_logits(plain)
        run["teacher_forced_s"] = time.perf_counter() - t0
        err = rel_err(got, want)
        agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
        run.update(logits_rel_err=err, tol=TOL_LOGITS, top1_agree=agree)
        log(f"B={B} teacher-forced logits vs plain: rel err {err:.3e} "
            f"(tol {TOL_LOGITS}), top-1 agreement {agree:.3f}")
        check(np.isfinite(got).all(), "non-finite logits")
        check(err < TOL_LOGITS, f"B={B} logits rel err {err}")

        if B != 1:
            continue
        # end to end: one decode step with the kernels vs the plain path,
        # at T valid positions, interleaved kernels, plain, plain, kernels
        def step_s(c, n=16):
            cache = dataclasses.replace(
                llama.KVCache.create(c, B, S),
                lengths=jnp.full((B,), T, jnp.int32))
            tok = forced[:, 0]
            lg, cache = llama.decode_step(params, c, tok, cache)
            jax.block_until_ready(lg)
            t0 = time.perf_counter()
            for _ in range(n):
                lg, cache = llama.decode_step(params, c, tok, cache)
            jax.block_until_ready(lg)
            return (time.perf_counter() - t0) / n
        plain_fast = dataclasses.replace(cfg, impl="xla")
        tk, tx = [], []
        for c, acc in ((cfg, tk), (plain_fast, tx), (plain_fast, tx),
                       (cfg, tk)):
            acc.append(step_s(c))
        run.update(step_ms_kernels=min(tk) * 1e3, step_ms_plain=min(tx) * 1e3)
        log(f"B={B} decode step at {T} positions: kernels "
            f"{run['step_ms_kernels']:.3f} ms, plain XLA "
            f"{run['step_ms_plain']:.3f} ms")
    stats = dev.memory_stats() or {}
    r["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"peak_bytes_in_use {r['peak_bytes_in_use']}")

    # depth-2 cut, full width, against the NumPy oracle on the host
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    qkv = lambda l: np.concatenate([np.asarray(l[k], np.float32)
                                    for k in ("wq", "wk", "wv")])
    gu = lambda l: np.concatenate([np.asarray(l[k], np.float32)
                                   for k in ("w_gate", "w_up")])
    ot, dv = {"layers": []}, {"layers": []}
    for l in cut["layers"]:
        ol = {"wqkv": native.quantize(qkv(l), "q4_k"),
              "w_gu": native.quantize(gu(l), "q4_k"),
              "wo": native.quantize(np.asarray(l["wo"], np.float32), "q4_k"),
              "w_down": native.quantize(np.asarray(l["w_down"], np.float32),
                                        "q4_k"),
              "attn_norm": np.asarray(l["attn_norm"], np.float32),
              "mlp_norm": np.asarray(l["mlp_norm"], np.float32)}
        ot["layers"].append(ol)
        dv["layers"].append({
            **{k: qm.from_oracle(ol[k]) for k in ("wqkv", "w_gu", "wo",
                                                 "w_down")},
            "attn_norm": jnp.asarray(l["attn_norm"]),
            "mlp_norm": jnp.asarray(l["mlp_norm"])})
    ot["lm_head"] = native.quantize(np.asarray(cut["lm_head"], np.float32),
                                    "q4_k")
    dv["lm_head"] = qm.from_oracle(ot["lm_head"])
    for k in ("embed", "final_norm"):
        ot[k] = np.asarray(cut[k], np.float32)
        dv[k] = jnp.asarray(cut[k])
    toks = rng.integers(0, cfg.vocab_size, (1, 64)).astype(np.int32)
    got, _ = llama.prefill(dv, cfg2, jnp.asarray(toks),
                           llama.KVCache.create(cfg2, 1, 64),
                           all_logits=True)
    want = om.forward_logits(ot, cfg2, toks)
    err = rel_err(got, want)
    r["depth2_oracle_rel_err"] = err
    log(f"depth-2 cut vs NumPy oracle: rel err {err:.3e} (tol {TOL_ORACLE})")
    check(err < TOL_ORACLE, f"depth-2 oracle rel err {err}")
    state["params"], state["cfg"] = params, cfg


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

# two prefill buckets (128 and 512 tokens), so two prefill compiles
PROMPT_LENS = (80, 128, 100, 512, 300, 480, 90, 400)
NEW_TOKENS = (16, 64, 32, 48, 24, 40, 56, 16)


def serve(params, cfg, quantized_kv, decode_window, rng) -> dict:
    import jax
    from ggml_cuda_experiments_tpu.models.engine import Engine
    eng = Engine(params, cfg, max_batch=8, page_size=64,
                 n_pages=8 * 2048 // 64 + 1, max_seq_len=2048,
                 quantized_kv=quantized_kv, decode_window=decode_window)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=m)
            for p, m in zip(prompts, NEW_TOKENS)]
    out = eng.run_to_completion()
    wall = time.perf_counter() - t0
    for rid, m in zip(rids, NEW_TOKENS):
        check(rid in out and len(out[rid]) == m,
              f"request {rid}: {len(out.get(rid, []))} of {m} tokens")
    return dict(requests=len(rids), tokens=sum(len(v) for v in out.values()),
                wall_s=wall, engine=eng)


def teacher_forced_engine(params, cfg, eng, rng, n_steps: int = 8) -> float:
    """Per-step logits of the engine's device path (paged prefill, then
    single-step paged decode) against the contiguous-cache model, both
    driven by the same tokens. Returns the relative max error."""
    import jax.numpy as jnp
    import numpy as np
    from ggml_cuda_experiments_tpu.models import llama
    T = 512
    prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, n_steps).astype(np.int32)
    # engine path: slot 0 active, its pages the first pages of the pool
    row = np.full((eng.pages_per_seq,), eng.trash_page, np.int32)
    row[: -(-(T + n_steps) // eng.page_size)] = np.arange(
        -(-(T + n_steps) // eng.page_size))
    pt = np.full((eng.max_batch, eng.pages_per_seq), eng.trash_page,
                 np.int32)
    pt[0] = row
    lg, pool = eng._prefill_fn(jnp.asarray(prompt[None]),
                               jnp.asarray(T, jnp.int32), jnp.asarray(row),
                               eng.pool)
    got = [np.asarray(lg)[0]]
    lens = np.ones((eng.max_batch,), np.int32)
    active = np.zeros((eng.max_batch,), bool)
    active[0] = True
    toks = np.zeros((eng.max_batch,), np.int32)
    for i in range(n_steps - 1):
        lens[0] = T + i
        toks[0] = forced[i]
        lg, pool = eng._decode_fn(jnp.asarray(toks), jnp.asarray(lens),
                                  jnp.asarray(pt), pool, jnp.asarray(active))
        got.append(np.asarray(lg)[0])
    eng.pool = pool
    cache = llama.KVCache.create(cfg, 1, 2048)
    lg, cache = llama.prefill(params, cfg, jnp.asarray(prompt[None]), cache)
    want = [np.asarray(lg)[0]]
    for i in range(n_steps - 1):
        lg, cache = llama.decode_step(params, cfg,
                                      jnp.asarray(forced[i:i + 1]), cache)
        want.append(np.asarray(lg)[0])
    return rel_err(np.stack(got), np.stack(want))


def phase_serving(report: dict, state: dict) -> None:
    import numpy as np
    params, cfg = state["params"], state["cfg"]
    rng = np.random.default_rng(SEED + 1)
    r = report.setdefault("serving", {})
    for name, qkv, window in (("int8", True, 8), ("bf16", False, 1)):
        res = serve(params, cfg, qkv, window, rng)
        eng = res.pop("engine")
        log(f"serving {name} pool: {res['requests']} requests, "
            f"{res['tokens']} tokens, {res['wall_s']:.2f} s wall "
            f"(compiles included)")
        if name == "bf16":
            err = teacher_forced_engine(params, cfg, eng, rng)
            res.update(logits_rel_err=err, tol=TOL_LOGITS)
            log(f"bf16 pool teacher-forced logits vs contiguous model: "
                f"rel err {err:.3e} (tol {TOL_LOGITS})")
            check(err < TOL_LOGITS, f"engine logits rel err {err}")
        del eng
        r[name] = res


# ---------------------------------------------------------------------------
# four cards: tensor-parallel engine vs one card
# ---------------------------------------------------------------------------

def phase_four_cards(report: dict, depth: int | None) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    from ggml_cuda_experiments_tpu.models.engine import (
        Engine, PagedKVPool, make_tp_engine_steps, paged_decode_step,
        paged_prefill, _pool_specs)
    from ggml_cuda_experiments_tpu.parallel import tp
    from ggml_cuda_experiments_tpu.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding

    check(len(jax.devices()) >= 4, f"need 4 cards, have {len(jax.devices())}")
    cfg = PRESETS["llama2-7b"]
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    r = report.setdefault("four_cards", {})
    t0 = time.perf_counter()
    host = llama.init_weights(cfg, seed=SEED, as_numpy=True)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), host)
    qp = tp.quantize_params_sharded(host, "q4_k", 4)
    mesh = make_mesh(model=4, data=1, devices=jax.devices()[:4])
    sparams = tp.shard_params(qp, mesh)
    del qp
    # the one-card reference quantizes the same weights globally: the
    # per-shard encoding of the row-parallel linears decodes only once
    # shard_map has sliced it, to identical values (shard cuts fall on
    # superblock bounds)
    d0 = jax.devices()[0]
    with jax.default_device(d0):
        one = llama.quantize_params(host, "q4_k")
    del host
    r["setup_s"] = time.perf_counter() - t0
    log(f"TP-4 setup {r['setup_s']:.1f} s")

    # per-step logits: same tokens through the TP-4 and one-card steps
    rng = np.random.default_rng(SEED)
    T, n_steps, ps, maxlen = 512, 8, 64, 2048
    n_pages = 8 * maxlen // ps + 1
    pps = maxlen // ps
    prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, n_steps).astype(np.int32)
    row = np.full((pps,), n_pages - 1, np.int32)
    row[:(T + n_steps) // ps + 1] = np.arange((T + n_steps) // ps + 1)
    pt = np.full((8, pps), n_pages - 1, np.int32)
    pt[0] = row
    active = np.zeros((8,), bool)
    active[0] = True

    pool_tp = PagedKVPool.create(cfg, n_pages, ps)
    pool_tp = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        pool_tp, _pool_specs(pool_tp))
    prefill_s, decode_s = make_tp_engine_steps(cfg, mesh, sparams, pool_tp)
    pool_1 = jax.device_put(PagedKVPool.create(cfg, n_pages, ps), d0)

    def drive(prefill, decode, pool):
        lg, pool = prefill(jnp.asarray(prompt[None]),
                           jnp.asarray(T, jnp.int32), jnp.asarray(row), pool)
        out = [np.asarray(lg)[0]]
        lens = np.ones((8,), np.int32)
        toks = np.zeros((8,), np.int32)
        t0 = time.perf_counter()
        for i in range(n_steps - 1):
            lens[0] = T + i
            toks[0] = forced[i]
            lg, pool = decode(jnp.asarray(toks), jnp.asarray(lens),
                              jnp.asarray(pt), pool, jnp.asarray(active))
            out.append(np.asarray(lg)[0])
        return np.stack(out), time.perf_counter() - t0

    got, t_tp = drive(lambda *a: prefill_s(sparams, *a),
                      lambda *a: decode_s(sparams, *a), pool_tp)
    with jax.default_device(d0):
        want, t_1 = drive(lambda *a: paged_prefill(one, cfg, *a),
                          lambda *a: paged_decode_step(one, cfg, *a), pool_1)
    err = rel_err(got, want)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    r.update(logits_rel_err=err, tol=TOL_LOGITS, top1_agree=agree,
             tp4_steps_s=t_tp, one_card_steps_s=t_1)
    log(f"TP-4 vs one card per-step logits: rel err {err:.3e} "
        f"(tol {TOL_LOGITS}), top-1 agreement {agree:.3f}")
    check(np.isfinite(got).all(), "non-finite TP-4 logits")
    check(err < TOL_LOGITS, f"TP-4 logits rel err {err}")

    # and the TP-4 Engine serving requests to completion
    eng = Engine(sparams, cfg, max_batch=8, page_size=ps, n_pages=n_pages,
                 max_seq_len=maxlen, mesh=mesh)
    lens_req = PROMPT_LENS[:4]
    rids = [eng.add_request(rng.integers(0, cfg.vocab_size, n).tolist(),
                            max_new_tokens=16) for n in lens_req]
    t0 = time.perf_counter()
    out = eng.run_to_completion()
    r["engine_wall_s"] = time.perf_counter() - t0
    for rid in rids:
        check(len(out.get(rid, [])) == 16, f"TP-4 request {rid}")
    log(f"TP-4 engine: {len(rids)} requests done in "
        f"{r['engine_wall_s']:.2f} s (compiles included)")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the tensor-parallel check on 4 cards")
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated subset of phases (default all)")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut the model to this many layers (default: all)")
    ap.add_argument("--json", default=None,
                    help="also write the full report to this file")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devs[0].platform}", file=sys.stderr)
        return 2
    import jaxlib
    from ggml_cuda_experiments_tpu.utils import platform
    cache_dir = platform.enable_compile_cache()

    report: dict = {}
    smi = nvidia_smi()
    report["device"] = dict(kind=devs[0].device_kind, count=len(devs),
                            nvidia_smi=smi, jax=jax.__version__,
                            jaxlib=jaxlib.__version__,
                            xla_flags=os.environ.get("XLA_FLAGS", ""),
                            compile_cache=cache_dir)
    log(f"phase 1 device: {devs[0].device_kind} x{len(devs)}, jax "
        f"{jax.__version__}, jaxlib {jaxlib.__version__}, XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}")
    log(f"nvidia-smi: {smi}")
    phases = {int(p) for p in args.phases.split(",")}
    state: dict = {}
    try:
        if args.four_cards:
            phase_four_cards(report, args.depth)
            count = 4
        else:
            t0 = time.perf_counter()
            for ph, name, fn in (
                    (2, "kernels", lambda: phase_kernels(report)),
                    (3, "model", lambda: phase_model(report, args.depth,
                                                     state)),
                    (4, "serving", lambda: phase_serving(report, state))):
                if ph not in phases:
                    continue
                if ph == 4 and "params" not in state:
                    raise Failed("phase 4 needs phase 3's model")
                log(f"phase {ph} {name}")
                t1 = time.perf_counter()
                fn()
                report[f"phase{ph}_s"] = time.perf_counter() - t1
                log(f"phase {ph} {name}: {report[f'phase{ph}_s']:.1f} s")
            report["total_s"] = time.perf_counter() - t0
            count = len(devs)
    finally:
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(report, indent=1,
                                                  default=str))
    log(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
