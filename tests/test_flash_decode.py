"""Split-KV flash decode vs the oracle — the analog of the reference's
flash_attn_row + fa_reduce path at kernel_test shapes (head_dim 128,
GQA 32/8, kv >= 256). Every case runs both implementations: the Triton
kernel (interpreted on the CPU) and the plain XLA path."""

import numpy as np
import jax.numpy as jnp
import pytest

from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu.oracle.attention import attention_ref
from ggml_cuda_experiments_tpu.utils.harness import assert_close

IMPLS = pytest.mark.parametrize("impl", ["kernel", "xla"])


def _decode_ref(q, k, v, lengths=None, scale=None):
    """Oracle: one-token attention with per-sequence lengths."""
    b, hq, d = q.shape
    sk = k.shape[2]
    mask = None
    if lengths is not None:
        mask = np.where(
            np.arange(sk)[None, None, None, :] < np.asarray(lengths)[:, None, None, None],
            0.0, -np.inf).astype(np.float32)
    out = attention_ref(q[:, :, None], k, v, mask=mask, scale=scale)
    return out[:, :, 0]


def _rand(rng, b, hq, hkv, s, d):
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    return q, k, v


@IMPLS
def test_single_split(rng, impl):
    q, k, v = _rand(rng, 1, 32, 8, 512, 128)
    got = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       kv_splits=1, impl=impl)
    want = _decode_ref(q, k, v)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="decode 1-split")


@pytest.mark.parametrize("splits", [2, 4])
def test_kv_splits_match_single(rng, splits):
    """Split-KV + LSE merge must equal the unsplit result — the core
    flash-decoding property (fa_reduce analog)."""
    q, k, v = _rand(rng, 2, 8, 4, 1024, 64)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want = _decode_ref(q, k, v)
    got = flash_decode(qj, kj, vj, kv_splits=splits, impl="kernel")
    assert_close(got, want, atol=2e-3, rtol=2e-3, name=f"decode {splits}-split")


@IMPLS
def test_varied_lengths(rng, impl):
    """Per-sequence lengths: positions past `length` are masked; blocks fully
    past it are skipped."""
    q, k, v = _rand(rng, 3, 8, 8, 768, 64)
    lengths = np.array([256, 700, 1], np.int32)
    got = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lengths), kv_splits=3, block_k=64,
                       impl=impl)
    want = _decode_ref(q, k, v, lengths)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="decode lengths")


@IMPLS
def test_length_not_block_multiple(rng, impl):
    q, k, v = _rand(rng, 1, 4, 4, 512, 64)
    lengths = np.array([300], np.int32)
    got = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lengths), block_k=32, impl=impl)
    want = _decode_ref(q, k, v, lengths)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="decode ragged length")


@IMPLS
def test_mqa_group_of_one(rng, impl):
    """Hq == Hkv (no grouping, Llama-2-7B's MHA) still works (G = 1,
    padded to the 16-row tensor-core tile)."""
    q, k, v = _rand(rng, 1, 4, 4, 256, 64)
    got = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       impl=impl)
    want = _decode_ref(q, k, v)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="decode G=1")


def test_matches_flash_attention_kernel(rng):
    """Cross-op consistency: decode == prefill attention with Sq=1."""
    from ggml_cuda_experiments_tpu.ops.attention import attention
    q, k, v = _rand(rng, 1, 8, 2, 256, 64)
    got = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       kv_splits=2, impl="kernel")
    got2 = attention(jnp.asarray(q[:, :, None]), jnp.asarray(k),
                     jnp.asarray(v))
    assert_close(got, np.asarray(got2)[:, :, 0], atol=2e-3, rtol=2e-3,
                 name="decode vs flash")


@IMPLS
def test_layered_cache_matches_sliced(rng, impl):
    """Full stacked cache [L, B, Hkv, S, D] + layer index must bit-match the
    per-layer-slice call (the kernel offsets to the layer itself, so the
    model never materializes a cache-layer slice)."""
    import jax
    L = 3
    q, _, _ = _rand(rng, 2, 8, 4, 512, 64)
    k = rng.normal(size=(L, 2, 4, 512, 64)).astype(np.float32)
    v = rng.normal(size=(L, 2, 4, 512, 64)).astype(np.float32)
    lengths = np.array([57, 300], np.int32)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    lj = jnp.asarray(lengths)
    for li in (0, 2):
        want = flash_decode(qj, kj[li], vj[li], lj, kv_splits=2, impl=impl)
        got = flash_decode(qj, kj, vj, lj, layer=li, kv_splits=2,
                           impl=impl)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # traced layer index (decode loop / scan body)
    f = jax.jit(lambda i: flash_decode(qj, kj, vj, lj, layer=i, impl=impl))
    np.testing.assert_array_equal(
        np.asarray(f(jnp.int32(1))),
        np.asarray(flash_decode(qj, kj[1], vj[1], lj, impl=impl)))


@IMPLS
def test_layered_cache_int8(rng, impl):
    from ggml_cuda_experiments_tpu.oracle.quant import quantize_int8_rowwise
    L = 2
    q, _, _ = _rand(rng, 1, 8, 4, 256, 64)
    k = rng.normal(size=(L, 1, 4, 256, 64)).astype(np.float32)
    v = rng.normal(size=(L, 1, 4, 256, 64)).astype(np.float32)
    kq, ks = quantize_int8_rowwise(k)
    vq, vs = quantize_int8_rowwise(v)
    lengths = jnp.asarray([200], jnp.int32)
    args = map(jnp.asarray, (q, kq, vq, ks[..., 0], vs[..., 0]))
    qj, kj, vj, ksj, vsj = args
    for li in range(L):
        want = flash_decode(qj, kj[li], vj[li], lengths,
                            k_scale=ksj[li], v_scale=vsj[li], impl=impl)
        got = flash_decode(qj, kj, vj, lengths,
                           k_scale=ksj, v_scale=vsj, layer=li, impl=impl)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@IMPLS
def test_int8_quantized_kv(rng, impl):
    """INT8 KV cache with per-token scales: kernel must match the oracle run
    on the dequantized cache (scale applied to score/prob rows is
    algebraically identical to dequantizing the tiles)."""
    from ggml_cuda_experiments_tpu.oracle.quant import (
        dequantize_int8_rowwise, quantize_int8_rowwise)
    q, k, v = _rand(rng, 2, 8, 4, 512, 64)
    kq, ks = quantize_int8_rowwise(k)
    vq, vs = quantize_int8_rowwise(v)
    kd = dequantize_int8_rowwise(kq, ks)
    vd = dequantize_int8_rowwise(vq, vs)
    lengths = np.array([300, 512], np.int32)

    got = flash_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths),
        k_scale=jnp.asarray(ks[..., 0]), v_scale=jnp.asarray(vs[..., 0]),
        kv_splits=2, impl=impl)
    want = _decode_ref(q, kd, vd, lengths)
    assert_close(got, want, atol=2e-2, rtol=2e-2, name="decode int8 kv")


@IMPLS
def test_fp8_quantized_kv(rng, impl):
    """FLOAT8_E4M3 KV cache with per-token scales (BASELINE's INT8/FP8 KV):
    kernel must match the oracle run on the dequantized cache."""
    import ml_dtypes
    from ggml_cuda_experiments_tpu.oracle.quant import (
        dequantize_fp8_rowwise, quantize_fp8_rowwise)
    q, k, v = _rand(rng, 2, 8, 4, 512, 64)
    kq, ks = quantize_fp8_rowwise(k)
    vq, vs = quantize_fp8_rowwise(v)
    kd = dequantize_fp8_rowwise(kq, ks)
    vd = dequantize_fp8_rowwise(vq, vs)
    lengths = np.array([300, 512], np.int32)

    got = flash_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths),
        k_scale=jnp.asarray(ks[..., 0]), v_scale=jnp.asarray(vs[..., 0]),
        kv_splits=2, impl=impl)
    want = _decode_ref(q, kd, vd, lengths)
    assert_close(got, want, atol=2e-2, rtol=2e-2, name="decode fp8 kv")


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (32, 8)])
@pytest.mark.parametrize("lengths,splits", [
    ((1, 64), 1),           # single position; exactly one block
    ((63, 65), 2),          # block edges +-1, split over two blocks
    ((128, 17), 8),         # full cache; more splits than valid blocks
])
def test_kernel_grid(rng, kv, hq, hkv, lengths, splits):
    """Kernel (interpreted) vs the plain path over KV dtype x GQA ratio x
    length edges x splits, on a 2-layer stacked cache (layer 1)."""
    from ggml_cuda_experiments_tpu.models.llama import _quantize_rowwise
    B, S, D, L = len(lengths), 128, 32, 2
    q = jnp.asarray(rng.normal(size=(B, hq, D)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(L, B, hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(L, B, hkv, S, D)), jnp.bfloat16)
    ks = vs = None
    if kv != "bf16":
        k, ks = _quantize_rowwise(k, kv)
        v, vs = _quantize_rowwise(v, kv)
    lens = jnp.asarray(lengths, jnp.int32)
    kw = dict(k_scale=ks, v_scale=vs, layer=1, block_k=32)
    got = flash_decode(q, k, v, lens, kv_splits=splits, impl="kernel", **kw)
    want = flash_decode(q.astype(jnp.float32), k, v, lens, impl="xla", **kw)
    assert_close(np.asarray(got, np.float32), np.asarray(want), atol=2e-2,
                 rtol=2e-2, name=f"decode {kv} {hq}/{hkv} {lengths}")


@pytest.mark.parametrize("b,hkv,s,want", [
    (1, 32, 4096, (64, 8)),     # 7B B=1: 32 blocks -> 8 splits
    (8, 32, 2048, (64, 1)),     # 7B B=8: 256 blocks already
    (1, 8, 4096, (64, 32)),     # GQA 32/8
    (1, 4, 48, (16, 2)),        # tiny cache: splits capped by its blocks
])
def test_decode_plan(b, hkv, s, want):
    from ggml_cuda_experiments_tpu.ops.flash_decode import decode_plan
    assert decode_plan(b, hkv, s) == want


def test_return_partial_merges(rng):
    """return_partial: two halves merged with the LSE combine == whole."""
    from ggml_cuda_experiments_tpu.ops.lse import lse_combine, lse_finalize
    q, k, v = _rand(rng, 2, 8, 4, 256, 32)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want = flash_decode(qj, kj, vj, impl="xla")
    lens = jnp.asarray([128, 128], jnp.int32)
    a = flash_decode(qj, kj[:, :, :128], vj[:, :, :128], lens,
                     return_partial=True, impl="kernel")
    b = flash_decode(qj, kj[:, :, 128:], vj[:, :, 128:], lens,
                     return_partial=True, impl="kernel")
    assert_close(lse_finalize(lse_combine(a, b)), want, atol=2e-3,
                 rtol=2e-3, name="partial merge")
