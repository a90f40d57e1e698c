"""End-to-end model tests (debug-sized Llama): cache-path consistency,
quantized-weight decode, scan-vs-host-loop generation equivalence."""

import numpy as np
import jax.numpy as jnp
import pytest

from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.models import llama
from ggml_cuda_experiments_tpu.utils.harness import assert_close

CFG = PRESETS["debug"]


@pytest.fixture(scope="module")
def params():
    return llama.init_weights(CFG, seed=3)


def _prompt(rng, b, t):
    return jnp.asarray(rng.integers(0, CFG.vocab_size, size=(b, t)),
                       jnp.int32)


def test_decode_matches_prefill(params, rng):
    """logits(prefill [t0..tN]) == logits(prefill [t0..tN-1] + decode tN):
    the KV-cache path and the full-attention path must agree — this pins
    flash_decode, cache writes, RoPE positions, and lengths all at once."""
    toks = _prompt(rng, 2, 8)
    cache_a = llama.KVCache.create(CFG, 2, 256)
    logits_full, _ = llama.prefill(params, CFG, toks, cache_a)

    cache_b = llama.KVCache.create(CFG, 2, 256)
    _, cache_b = llama.prefill(params, CFG, toks[:, :-1], cache_b)
    logits_inc, _ = llama.decode_step(params, CFG, toks[:, -1], cache_b)

    assert_close(logits_inc, logits_full, atol=2e-2, rtol=2e-2,
                 name="decode vs prefill logits")


def test_generate_runs_and_is_deterministic(params, rng):
    toks = _prompt(rng, 1, 8)
    out1 = llama.generate(params, CFG, toks, steps=6)
    out2 = llama.generate(params, CFG, toks, steps=6)
    assert out1.shape == (1, 6)
    assert np.array_equal(out1, out2)
    assert np.all((out1 >= 0) & (out1 < CFG.vocab_size))


def test_generate_scan_matches_host_loop(params, rng):
    toks = _prompt(rng, 2, 8)
    want = llama.generate(params, CFG, toks, steps=5)
    cache = llama.KVCache.create(CFG, 2, 256)
    got = np.asarray(llama.generate_scan(params, CFG, toks, cache, 5))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_quantized_decode(params, rng, fmt):
    """Quantized model must run the fused-dequant path and stay close to the
    dense model (q8_0 tight, q4_k loose)."""
    qparams = llama.quantize_params(params, fmt)
    toks = _prompt(rng, 1, 8)
    cache_d = llama.KVCache.create(CFG, 1, 256)
    cache_q = llama.KVCache.create(CFG, 1, 256)
    ld, _ = llama.prefill(params, CFG, toks, cache_d)
    lq, _ = llama.prefill(qparams, CFG, toks, cache_q)
    ld, lq = np.asarray(ld), np.asarray(lq)
    # correlation of logits stays high even under 4-bit error
    c = np.corrcoef(ld.ravel(), lq.ravel())[0, 1]
    assert c > (0.999 if fmt == "q8_0" else 0.95), f"logit corr {c}"
    assert np.all(np.isfinite(lq))


def test_ragged_batch_decode(params, rng):
    """Sequences of different lengths in one batch decode independently:
    batch result == per-sequence result."""
    t1 = _prompt(rng, 1, 8)
    t2 = _prompt(rng, 1, 8)
    # batched: both prompts together
    toks = jnp.concatenate([t1, t2])
    cache = llama.KVCache.create(CFG, 2, 256)
    logits_b, cache = llama.prefill(params, CFG, toks, cache)
    # singles
    for i, t in enumerate((t1, t2)):
        c = llama.KVCache.create(CFG, 1, 256)
        logits_s, _ = llama.prefill(params, CFG, t, c)
        assert_close(logits_b[i:i+1], logits_s, atol=2e-2, rtol=2e-2,
                     name=f"batch independence seq {i}")


def test_int8_kv_cache_decode(params, rng):
    """INT8-quantized KV cache end-to-end: decode logits track the bf16-cache
    model closely (int8 per-token KV error ~1%)."""
    toks = _prompt(rng, 2, 8)
    cache_f = llama.KVCache.create(CFG, 2, 256)
    cache_q = llama.KVCache.create(CFG, 2, 256, quantized=True)
    assert cache_q.quantized and not cache_f.quantized

    lf, cache_f = llama.prefill(params, CFG, toks, cache_f)
    lq, cache_q = llama.prefill(params, CFG, toks, cache_q)
    # prefill itself attends over fresh bf16 K/V -> logits nearly equal
    assert_close(lq, lf, atol=2e-2, rtol=2e-2, name="int8kv prefill")

    nxt = jnp.argmax(lf, -1).astype(jnp.int32)
    df, _ = llama.decode_step(params, CFG, nxt, cache_f)
    dq, _ = llama.decode_step(params, CFG, nxt, cache_q)
    # decode reads the quantized cache -> small extra error
    c = np.corrcoef(np.asarray(df).ravel(), np.asarray(dq).ravel())[0, 1]
    assert c > 0.999, f"int8 kv decode corr {c}"


def test_fp8_kv_cache_decode(params, rng):
    """FLOAT8_E4M3 KV cache end-to-end: decode logits correlate with the
    bf16-cache model (e4m3's ~3 mantissa bits cost more than int8's uniform
    grid on near-amax entries, hence the looser gate), and generation runs.
    Exact kernel-level correctness vs the dequantized cache is asserted in
    tests/test_flash_decode.py::test_fp8_quantized_kv."""
    toks = _prompt(rng, 2, 8)
    cache_f = llama.KVCache.create(CFG, 2, 256)
    cache_q = llama.KVCache.create(CFG, 2, 256, quantized="fp8")
    assert cache_q.quant_fmt == "fp8"

    lf, cache_f = llama.prefill(params, CFG, toks, cache_f)
    lq, cache_q = llama.prefill(params, CFG, toks, cache_q)
    assert_close(lq, lf, atol=2e-2, rtol=2e-2, name="fp8kv prefill")

    nxt = jnp.argmax(lf, -1).astype(jnp.int32)
    df, _ = llama.decode_step(params, CFG, nxt, cache_f)
    dq, _ = llama.decode_step(params, CFG, nxt, cache_q)
    c = np.corrcoef(np.asarray(df).ravel(), np.asarray(dq).ravel())[0, 1]
    assert c > 0.99, f"fp8 kv decode corr {c}"

    cache = llama.KVCache.create(CFG, 1, 256, quantized="fp8")
    out = llama.generate(params, CFG, toks[:1], steps=4, cache=cache)
    assert out.shape == (1, 4)


def test_fused_mlp_layout_generate(rng):
    """The fused projection layout (wqkv, gate|up concatenated in w_gu)
    must generate the same tokens as the plain per-projection
    quantization, with x_quant8 decode numerics."""
    import dataclasses
    from ggml_cuda_experiments_tpu.models.config import PRESETS
    cfg = dataclasses.replace(
        PRESETS["debug"], dim=4096, intermediate=4096, n_layers=1,
        n_heads=8, n_kv_heads=8, head_dim=64, vocab_size=256,
        x_quant8=True)
    params = llama.init_weights(cfg, seed=5, as_numpy=True)
    qf = llama.quantize_params(params, "q4_k")           # fused layout
    qs = llama.quantize_params(params, "q4_k", fuse=False)
    assert "w_gu" in qf["layers"][0] and "wqkv" in qf["layers"][0]
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 8)), jnp.int32)
    tf = llama.generate(qf, cfg, prompt, steps=4)[0].tolist()
    ts = llama.generate(qs, cfg, prompt, steps=4)[0].tolist()
    # same quantized rows, different product grouping — tokens agree
    agree = sum(a == b for a, b in zip(tf, ts))
    assert agree >= 3, (tf, ts)
