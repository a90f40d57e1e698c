"""Quantized linears vs the quantization oracle.

The correctness contract: qmatmul == x @ dequant^T computed entirely by the
NumPy oracle — dequantization must be bit-identical, so the only difference
is accumulation order (f32) or bf16 operand rounding. The fused Triton
matvec runs in Pallas' interpreter here (impl="kernel"); the plain path is
impl="xla"."""

import numpy as np
import jax.numpy as jnp
import pytest

from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
from ggml_cuda_experiments_tpu.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu.utils.harness import assert_close

FMTS = ["q8_0", "q4_0", "q4_k"]


def _device_dequant_ref(fmt, t, enc="e"):
    """The device dequant contract: GGML semantics for q8_0/q4_0; the
    Q6_K-E encoding for q6_k; for q4_k, the Q4_K-E bf16 effective scales
    (the default), or with ``enc="s6"`` the opt-in storage encoding's
    semantics (f32 = bf16(d) * exact 6-bit sc, in-kernel decode)."""
    import ml_dtypes
    if fmt == "q6_k":
        n, k = t.shape
        es = (np.repeat(t.d, 16, -1) * t.sc.astype(np.float32)
              ).astype(ml_dtypes.bfloat16).astype(np.float32)
        q = t.qs.reshape(n, k // 16, 16).astype(np.float32) - 32.0
        return (q * es[..., None]).reshape(n, k)
    if fmt != "q4_k":
        return quant_ref.FORMATS[fmt][1](t)
    n, k = t.shape
    if enc == "s6":
        dbf = t.d.astype(ml_dtypes.bfloat16).astype(np.float32)
        dmbf = t.dmin.astype(ml_dtypes.bfloat16).astype(np.float32)
        es = np.repeat(dbf, 8, -1) * t.sc.astype(np.float32)
        em = np.repeat(dmbf, 8, -1) * t.mn.astype(np.float32)
    else:                                # Q4_K-E
        es, em = qm.q4_k_effective(t)
        es = es.astype(np.float32)
        em = em.astype(np.float32)
    q = quant_ref.unpack_nibbles(t.qs.reshape(n, k // 32, 16)).astype(np.float32)
    return (q * es[..., None] - em[..., None]).reshape(n, k)


@pytest.mark.parametrize("fmt", FMTS)
def test_device_dequant_matches_contract(rng, fmt):
    """dequantize_jnp must reproduce the device dequant contract
    bit-for-bit."""
    w = rng.normal(size=(64, 512)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    want = _device_dequant_ref(fmt, t)
    ql = qm.from_oracle(t)
    got = np.asarray(qm.dequantize_jnp(ql))
    assert np.array_equal(got, want), f"{fmt} dequant mismatch"


def test_q4_k_e_encoding_close_to_ggml(rng):
    """The Q4_K-E bf16 effective scales stay within ~0.4% of exact GGML
    Q4_K dequantization — far below the 4-bit quantization step."""
    w = rng.normal(size=(32, 512)).astype(np.float32)
    t = quant_ref.quantize_q4_k(w)
    exact = quant_ref.dequantize_q4_k(t)
    device = _device_dequant_ref("q4_k", t)
    denom = max(1e-6, float(np.abs(exact).max()))
    assert float(np.abs(device - exact).max()) / denom < 0.01


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("batch", [1, 8])
def test_qmatmul_fused_f32(rng, fmt, batch):
    """compute_dtype=f32: the kernel matches the oracle to accumulation
    error only (dequant itself is bit-exact)."""
    n, k = 256, 1024
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(batch, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref(fmt, t).T
    got = qm.qmatmul(jnp.asarray(x), ql, block_n=128, impl="kernel",
                     compute_dtype=jnp.float32)
    assert_close(got, want, atol=5e-3, rtol=5e-3, name=f"qmatmul {fmt} B={batch}")


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("batch,impl", [(1, "kernel"), (8, "kernel"),
                                        (1, "xla")])
def test_qmatmul_fused_bf16_default(rng, fmt, batch, impl):
    """Default bf16 compute (tensor-core operands): f16-level accuracy,
    like the reference's fp16 WMMA dequant path."""
    n, k = 256, 1024
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(batch, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref(fmt, t).T
    got = qm.qmatmul(jnp.asarray(x), ql, block_n=128, impl=impl)
    # bf16 weight rounding ~0.4% relative; amplified by K-sum cancellation
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err < 0.02 * scale, f"{fmt} B={batch} {impl}: err {err} vs {scale}"


@pytest.mark.parametrize("fmt", FMTS)
def test_qmatmul_xla_baseline(rng, fmt):
    n, k = 128, 512
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(4, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref(fmt, t).T
    got = qm.qmatmul_xla(jnp.asarray(x), ql)
    assert_close(got, want, atol=5e-3, rtol=5e-3, name=f"qmatmul_xla {fmt}")


def test_qmatmul_unaligned_n(rng):
    """N not a power of two (320 = 5 x 64): the row tile divides N."""
    n, k = 320, 512
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(2, k)).astype(np.float32)
    t = quant_ref.quantize_q8_0(w)
    ql = qm.from_oracle(t)
    want = x @ quant_ref.dequantize_q8_0(t).T
    got = qm.qmatmul(jnp.asarray(x), ql, impl="kernel",
                     compute_dtype=jnp.float32)
    assert_close(got, want, atol=5e-3, rtol=5e-3, name="qmatmul unaligned N")


def test_nbytes_counts_packed_nibbles(rng):
    w = rng.normal(size=(64, 512)).astype(np.float32)
    ql = qm.quantize(w, "q4_0")
    # 4 bits/weight + f32 scale per 32
    assert ql.nbytes == 64 * 512 // 2 + 64 * (512 // 32) * 4


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("k", [1024, 5632, 11008])
def test_qmatvec_any_k(rng, fmt, k):
    """The kernel handles any K multiple of 256, incl. K/32 not a power of
    two (5632: TinyLlama's FFN; 11008: Llama-2-7B's w_down)."""
    n = 64
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(1, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref(fmt, t).T
    got = qm.qmatmul(jnp.asarray(x), ql, impl="kernel",
                     compute_dtype=jnp.float32)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err < 1e-4 * scale, f"{fmt} K={k}: err {err} vs scale {scale}"


@pytest.mark.parametrize("batch", [2, 5, 8, 16])
def test_qmatvec_batched(rng, batch):
    """Decode batches up to KERNEL_MAX_ROWS: x padded to 16 rows."""
    n, k = 128, 1024
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(batch, k)).astype(np.float32)
    t = quant_ref.quantize_q4_k(w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref("q4_k", t).T
    got = qm.qmatmul(jnp.asarray(x), ql, impl="kernel",
                     compute_dtype=jnp.float32)
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() < 1e-4 * scale


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("k_splits", [1, 2, 4])
def test_kernel_k_splits(rng, fmt, k_splits):
    """Partial sums over K splits (added in XLA) == one split."""
    n, k = 64, 4096
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(3, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref(fmt, t).T
    got = qm.qmatmul(jnp.asarray(x), ql, impl="kernel", k_splits=k_splits,
                     compute_dtype=jnp.float32)
    assert_close(got, want, atol=5e-3, rtol=5e-3, name=f"splits {k_splits}")


@pytest.mark.parametrize("k,k_splits,rows", [(11008, 2, 1), (11008, 3, 3),
                                             (5632, 5, 1)])
def test_kernel_uneven_k_splits(rng, k, k_splits, rows):
    """Splits that do not divide the step count: the last split takes the
    remainder (43 steps at K=11008), and the sum is still exact."""
    n = 64
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    t = quant_ref.quantize_q4_k(w)
    ql = qm.from_oracle(t)
    plan = qm.kernel_plan(n, k, rows, k_splits=k_splits)
    assert plan["chunks"] % k_splits != 0
    want = x @ _device_dequant_ref("q4_k", t).T
    got = qm.qmatmul(jnp.asarray(x), ql, impl="kernel", k_splits=k_splits,
                     compute_dtype=jnp.float32)
    assert_close(got, want, atol=5e-3, rtol=5e-3,
                 name=f"K={k} splits {k_splits}")


def test_misaligned_k_mxu_falls_back(rng):
    """Rows past KERNEL_MAX_ROWS take XLA's dequantize + dot."""
    n, k = 64, 5632
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(qm.KERNEL_MAX_ROWS + 1, k)).astype(np.float32)
    t = quant_ref.quantize_q8_0(w)
    ql = qm.from_oracle(t)
    assert qm.choose_impl(ql, x.shape[0], None) == "xla"
    want = x @ quant_ref.dequantize_q8_0(t).T
    got = qm.qmatmul(jnp.asarray(x), ql)
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() < 2e-2 * scale


@pytest.mark.parametrize("case,backend,want", [
    (dict(fmt="q4_k", rows=1), "gpu", "kernel"),
    (dict(fmt="q4_k", rows=32), "gpu", "kernel"),
    (dict(fmt="q4_k", rows=33), "gpu", "xla"),         # prefill rows
    (dict(fmt="q6_k", rows=1, unfit=True), "gpu", "xla"),  # no q6_k kernel
    (dict(fmt="q4_k", rows=1, n=24, unfit=True), "gpu", "xla"),  # no tile
    (dict(fmt="q4_k", rows=1), "cpu", "xla"),
])
def test_choose_impl(monkeypatch, rng, case, backend, want):
    """The op choice is a rule over format, rows and N; asking for the
    kernel where it cannot tile raises instead of falling back."""
    from ggml_cuda_experiments_tpu.utils import platform
    n = case.get("n", 64)
    w = rng.normal(size=(n, 512)).astype(np.float32)
    ql = qm.quantize(w, case["fmt"])
    monkeypatch.setattr(platform, "backend", lambda: backend)
    assert qm.choose_impl(ql, case["rows"]) == want
    if case.get("unfit"):
        with pytest.raises(ValueError):
            qm.choose_impl(ql, case["rows"], "kernel")


@pytest.mark.parametrize("fmt", FMTS)
def test_prefill_rows_xla(rng, fmt):
    """Prefill-sized products (T rows) run dequantize + one dot; x is
    reordered to the stored column order instead of the weight."""
    n, k, t_rows = 128, 1024, 64
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(t_rows, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    want = x @ _device_dequant_ref(fmt, t).T
    got = qm.qmatmul(jnp.asarray(x), ql, compute_dtype=jnp.float32)
    assert_close(got, want, atol=5e-3, rtol=5e-3, name=f"prefill {fmt}")


@pytest.mark.parametrize("fmt", ["q4_k", "q4_0"])
def test_qmatmul_x_quant8(rng, fmt):
    """llama.cpp Q4_K x Q8 decode numerics: activations per-32-block
    int8-quantized first. Accuracy class ~0.5% rel; the kernel and the
    plain path agree on the quantized activations."""
    n, k = 640, 4096
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    ql = qm.quantize(w, fmt)
    x = jnp.asarray(rng.normal(size=(1, k)).astype(np.float32))
    want = np.asarray(qm.qmatmul_xla(x, ql, compute_dtype=jnp.float32))
    got = np.asarray(qm.qmatmul(x, ql, impl="kernel", x_quant8=True))
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err < 2e-2 * scale, f"{fmt} x_quant8: err {err} vs scale {scale}"
    plain = np.asarray(qm.qmatmul(x, ql, impl="xla", x_quant8=True))
    assert np.abs(got - plain).max() < 1e-2 * scale


def test_fake_quant8_commutes_with_layout(rng):
    """Per-32-block activation quantization maps logical blocks onto whole
    stored blocks, so it commutes with the column interleave."""
    for k in (1024, 12288):
        x = jnp.asarray(rng.normal(size=(2, k)).astype(np.float32))
        a = qm.permute_activations(qm.fake_quant8(x))
        p = qm.permute_activations(x)
        # quantize the permuted vector by its own stored blocks
        cols = np.concatenate([qm._block_cols(k)] * 2)
        pn = np.asarray(p)
        want = np.empty_like(pn)
        for c in np.unique(cols):
            sel = cols == c
            amax = np.abs(pn[:, sel]).max(axis=1, keepdims=True)
            sc = np.where(amax == 0, 1.0, amax / 127.0)
            want[:, sel] = np.clip(np.round(pn[:, sel] / sc), -127, 127) * sc
        np.testing.assert_allclose(np.asarray(a), want, rtol=1e-6, atol=1e-7)


def test_qmatmul_chunk_exact_fold(rng):
    """The kernel in f32 is exact up to f32 summation order: tight
    tolerance vs the f32 XLA reference."""
    n, k = 512, 4096
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    ql = qm.quantize(w, "q4_k")
    x = jnp.asarray(rng.normal(size=(1, k)).astype(np.float32))
    want = np.asarray(qm.qmatmul_xla(x, ql, compute_dtype=jnp.float32))
    got = np.asarray(qm.qmatmul(x, ql, impl="kernel",
                                compute_dtype=jnp.float32))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale


def test_model_x_quant8_decode(rng):
    """End-to-end decode step with cfg.x_quant8: logits stay close to the
    exact decode (int8 activation quantization error only)."""
    import dataclasses
    from ggml_cuda_experiments_tpu.models import llama
    from ggml_cuda_experiments_tpu.models.config import ModelConfig

    cfg = ModelConfig(name="t", vocab_size=256, dim=4096, n_layers=1,
                      n_heads=4, n_kv_heads=2, intermediate=4096,
                      head_dim=64, max_seq_len=128)
    params = llama.init_weights(cfg, seed=0)
    params = llama.quantize_params(params, "q4_k")
    cache = llama.KVCache.create(cfg, 1, 128)
    tok = jnp.zeros((1,), jnp.int32)
    exact, _ = llama.decode_step(params, cfg, tok, cache)
    cfg8 = dataclasses.replace(cfg, x_quant8=True)
    cache = llama.KVCache.create(cfg, 1, 128)
    q8, _ = llama.decode_step(params, cfg8, tok, cache)
    exact, q8 = np.asarray(exact), np.asarray(q8)
    scale = np.abs(exact).max()
    assert np.abs(q8 - exact).max() < 3e-2 * scale


# ---------------------------------------------------------------------------
# q6_k (16-element scale blocks; its own lane order; plain XLA path)
# ---------------------------------------------------------------------------

def test_q6_device_dequant_matches_contract(rng):
    w = rng.normal(size=(64, 512)).astype(np.float32)
    t = quant_ref.quantize_q6_k(w)
    ql = qm.from_oracle(t)
    got = np.asarray(qm.dequantize_jnp(ql))
    assert np.array_equal(got, _device_dequant_ref("q6_k", t))


def test_q6_k_e_encoding_close_to_exact(rng):
    """bf16 effective per-16 scales stay well inside the 6-bit step."""
    w = rng.normal(size=(32, 512)).astype(np.float32)
    t = quant_ref.quantize_q6_k(w)
    exact = quant_ref.dequantize_q6_k(t)
    device = _device_dequant_ref("q6_k", t)
    denom = max(1e-6, float(np.abs(exact).max()))
    assert float(np.abs(device - exact).max()) / denom < 0.005


def test_q6_chunk_kernel_matvec(rng):
    """B=1 q6_k matvec (global lane order): accumulation error only."""
    n, k = 256, 2048
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    t = quant_ref.quantize_q6_k(w)
    ql = qm.from_oracle(t)
    x = rng.normal(size=(1, k)).astype(np.float32)
    got = np.asarray(qm.qmatmul(jnp.asarray(x), ql,
                                compute_dtype=jnp.float32))
    want = x @ _device_dequant_ref("q6_k", t).T
    assert_close(got, want, atol=5e-4, rtol=5e-4, name="q6_k matvec")


@pytest.mark.parametrize("k", [4096, 8192])
def test_q6_hybrid_kernel_matvec(rng, k):
    """K % 4096 == 0 uses the segment-local q6 lane order."""
    n = 256
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    t = quant_ref.quantize_q6_k(w)
    ql = qm.from_oracle(t)
    x = rng.normal(size=(1, k)).astype(np.float32)
    got = np.asarray(qm.qmatmul(jnp.asarray(x), ql,
                                compute_dtype=jnp.float32))
    want = x @ _device_dequant_ref("q6_k", t).T
    denom = max(1e-6, float(np.abs(want).max()))
    rel = float(np.abs(got - want).max()) / denom
    assert rel < 1e-4, rel


def test_q6_dequant_roundtrip_seg_layout(rng):
    """dequantize_jnp must invert the segment-local lane order exactly."""
    n, k = 64, 4096
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    t = quant_ref.quantize_q6_k(w)
    got = np.asarray(qm.dequantize_jnp(qm.from_oracle(t)))
    assert np.array_equal(got, _device_dequant_ref("q6_k", t))


@pytest.mark.parametrize("batch,k", [(1, 1024), (8, 2048)])
def test_q6_fallback_paths(rng, batch, k):
    """q6_k has no kernel: every row count routes to the XLA path."""
    n = 128
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    t = quant_ref.quantize_q6_k(w)
    ql = qm.from_oracle(t)
    assert qm.choose_impl(ql, batch) == "xla"
    x = rng.normal(size=(batch, k)).astype(np.float32)
    got = np.asarray(qm.qmatmul(jnp.asarray(x), ql))
    want = x @ _device_dequant_ref("q6_k", t).T
    assert_close(got, want, atol=3e-2, rtol=3e-2, name="q6_k fallback")


def test_q6_quantize_entry(rng):
    """quantize(w, 'q6_k') end-to-end (native codec)."""
    w = rng.normal(size=(64, 512)).astype(np.float32)
    ql = qm.quantize(w, "q6_k")
    assert ql.fmt == "q6_k" and ql.qh is not None
    deq = np.asarray(qm.dequantize_jnp(ql))
    rel = np.abs(deq - w).max() / np.abs(w).max()
    assert rel < 0.05


# ---------------------------------------------------------------------------
# segment-local interleave (K % 4096 == 0, K > 4096): every path must agree
# with the stored layout
# ---------------------------------------------------------------------------

def test_segment_layout_invariants():
    """The segment-local perm keeps the two nibble-half lanes of byte i at
    (i, i+K/2), keeps both lanes of a byte in one scale block, and maps
    lane j to stored scale column ((j % (K/2)) // 2048)*128 + j % 128."""
    k = 12288
    p, p32 = qm._perm(k), qm._perm32(k)
    assert np.array_equal(np.sort(p), np.arange(k))
    assert np.array_equal(np.sort(p32), np.arange(k // 32))
    j = np.arange(k)
    col = ((j % (k // 2)) // 2048) * 128 + (j % 128)   # stored scale column
    lo_blk = p[: k // 2] // 32                         # logical block of lane
    hi_blk = p[k // 2:] // 32
    # byte i pairs lanes (i, i+K/2): both nibbles share a scale block
    assert np.array_equal(lo_blk, hi_blk)
    # the stored scale column of lane j holds lane j's logical block
    assert np.array_equal(p32[col], p // 32)


@pytest.mark.parametrize("k", [512, 1024, 5632, 11008, 12288])
def test_block_cols_table(k):
    """_block_cols (the kernel's scale-column table) names the stored
    column that holds each byte-lane's logical block."""
    p, p32 = qm._perm(k), qm._perm32(k)
    cols = qm._block_cols(k)
    assert cols.shape == (k // 2,) and cols.dtype == np.int32
    assert np.array_equal(p32[cols], p[: k // 2] // 32)
    assert np.array_equal(p32[cols], p[k // 2:] // 32)


def test_segment_layout_permute_activations(rng):
    """permute_activations must equal gathering by _perm for seg layouts."""
    for k in (8192, 12288):
        x = rng.normal(size=(2, k)).astype(np.float32)
        got = np.asarray(qm.permute_activations(jnp.asarray(x)))
        assert np.array_equal(got, x[:, qm._perm(k)]), f"K={k}"


@pytest.mark.parametrize("fmt", FMTS)
def test_segment_dequant_contract(rng, fmt):
    """dequantize_jnp round-trips the segment-local encoding bit-for-bit."""
    n, k = 16, 8192
    w = rng.normal(size=(n, k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    got = np.asarray(qm.dequantize_jnp(qm.from_oracle(t)))
    assert np.array_equal(got, _device_dequant_ref(fmt, t)), fmt


@pytest.mark.parametrize("k", [8192, 12288])
@pytest.mark.parametrize("path", ["kernel_b1", "kernel_xq8", "kernel_b8",
                                  "q8_kernel_b1", "xla"])
def test_segment_layout_all_paths(rng, k, path):
    """Every path agrees with the oracle under the segment-local layout
    (q4_k except the q8_0 case)."""
    n = 256
    fmt = "q8_0" if path == "q8_kernel_b1" else "q4_k"
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    t = quant_ref.FORMATS[fmt][0](w)
    ql = qm.from_oracle(t)
    b = {"kernel_b8": 8, "xla": 4}.get(path, 1)
    x = rng.normal(size=(b, k)).astype(np.float32)
    want = x @ _device_dequant_ref(fmt, t).T
    xj = jnp.asarray(x)
    tol = 1e-4                           # f32: summation order only
    if path == "xla":
        got = qm.qmatmul_xla(xj, ql, compute_dtype=jnp.float32)
    elif path == "kernel_xq8":
        got = qm.qmatmul(xj, ql, impl="kernel", x_quant8=True)
        tol = 2e-2                       # int8 activation quantization
    else:
        got = qm.qmatmul(xj, ql, impl="kernel", compute_dtype=jnp.float32)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err < tol * scale, f"{path} K={k}: err {err} vs scale {scale}"


# ---------------------------------------------------------------------------
# s6 opt-in storage encoding: expanded to "e" before every product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4096, 12288])
@pytest.mark.parametrize("path", ["kernel_b1", "kernel_xq8", "kernel_b16",
                                  "xla"])
def test_s6_encoding_all_paths(rng, k, path):
    """from_oracle(enc="s6") against the s6 dequant contract on each path
    (the s6 wire layout: combined int8 sc|mn + bf16 superblock d|dmin,
    quant_matmul module docstring)."""
    n = 256
    w = rng.normal(size=(n, k)).astype(np.float32) / np.sqrt(k)
    t = quant_ref.quantize_q4_k(w)
    ql = qm.from_oracle(t, enc="s6")
    assert ql.enc == "s6" and ql.em is None
    assert ql.nbytes * 8 / (n * k) == pytest.approx(4.625)
    want_w = _device_dequant_ref("q4_k", t, enc="s6")
    np.testing.assert_array_equal(
        np.asarray(qm.dequantize_jnp(ql)), want_w)
    B = 16 if path == "kernel_b16" else 1
    x = rng.normal(size=(B, k)).astype(np.float32)
    want = x @ want_w.T
    xj = jnp.asarray(x)
    tol = 1e-4
    if path == "xla":
        got = qm.qmatmul_xla(xj, ql, compute_dtype=jnp.float32)
    elif path == "kernel_xq8":
        got = qm.qmatmul(xj, ql, impl="kernel", x_quant8=True)
        tol = 2e-2
    else:
        got = qm.qmatmul(xj, ql, impl="kernel", compute_dtype=jnp.float32)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err < tol * scale, f"s6 {path} K={k}: err {err} vs {scale}"


@pytest.mark.parametrize("n,k,rows", [
    (12288, 4096, 1), (22016, 4096, 1), (4096, 4096, 1), (4096, 11008, 1),
    (32000, 4096, 1), (12288, 4096, 8), (4096, 11008, 8), (32000, 4096, 16),
])
def test_plans_zero_pad_for_model_shapes(n, k, rows):
    """Llama-2-7B's decode shapes (fused wqkv, fused w_gu, wo, w_down,
    head) tile with no padding: the row tile divides N, the byte-lane
    chunk divides K/2, the splits cover the chunks with none empty, and x
    pads to 16 rows (one row stays unpadded)."""
    p = qm.kernel_plan(n, k, rows)
    assert p["ok"], p
    assert n % p["bn"] == 0 and (k // 2) % p["bc"] == 0
    chunks = k // 2 // p["bc"]
    assert p["chunks"] == chunks
    assert (p["k_splits"] - 1) * p["chunks_per_split"] < chunks \
        <= p["k_splits"] * p["chunks_per_split"]
    assert p["bp"] == (1 if rows == 1 else 16)
