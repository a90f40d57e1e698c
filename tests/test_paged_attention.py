"""Paged decode vs contiguous decode vs oracle: gathering scattered pages
must be numerically identical to a contiguous cache. Every case runs the
Triton kernel (interpreted on the CPU) and the plain gather path."""

import numpy as np
import jax.numpy as jnp
import pytest

from ggml_cuda_experiments_tpu.ops.paged_attention import paged_decode
from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu.oracle.quant import (
    dequantize_fp8_rowwise, dequantize_int8_rowwise,
    quantize_fp8_rowwise, quantize_int8_rowwise)
from ggml_cuda_experiments_tpu.utils.harness import assert_close

IMPLS = pytest.mark.parametrize("impl", ["kernel", "xla"])


def _paged_setup(rng, B, Hq, Hkv, D, page_size, pages_per_seq, lengths):
    """Build a page pool holding each sequence's KV at random physical pages,
    plus the equivalent contiguous cache."""
    S = pages_per_seq * page_size
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)

    n_pages = B * pages_per_seq + 3
    perm = rng.permutation(n_pages)[: B * pages_per_seq]
    page_indices = perm.reshape(B, pages_per_seq).astype(np.int32)

    k_pages = np.zeros((n_pages, Hkv, page_size, D), np.float32)
    v_pages = np.zeros((n_pages, Hkv, page_size, D), np.float32)
    for b in range(B):
        for pi in range(pages_per_seq):
            phys = page_indices[b, pi]
            sl = slice(pi * page_size, (pi + 1) * page_size)
            k_pages[phys] = k[b, :, sl]
            v_pages[phys] = v[b, :, sl]
    return q, k, v, k_pages, v_pages, page_indices


@IMPLS
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_paged_matches_contiguous(rng, splits, impl):
    B, Hq, Hkv, D, ps, pps = 2, 8, 4, 64, 64, 8
    lengths = np.array([300, 512], np.int32)
    q, k, v, kp, vp, pidx = _paged_setup(rng, B, Hq, Hkv, D, ps, pps, lengths)

    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lengths))
    got = paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(lengths), jnp.asarray(pidx),
                       kv_splits=splits, impl=impl)
    assert_close(np.asarray(got), np.asarray(want), atol=2e-3, rtol=2e-3,
                 name=f"paged splits={splits}")


@IMPLS
def test_paged_short_sequences(rng, impl):
    """Sequences much shorter than the allocation: tail blocks skipped."""
    B, Hq, Hkv, D, ps, pps = 3, 4, 2, 64, 32, 8
    lengths = np.array([1, 33, 250], np.int32)
    q, k, v, kp, vp, pidx = _paged_setup(rng, B, Hq, Hkv, D, ps, pps, lengths)
    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lengths), block_k=32)
    got = paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(lengths), jnp.asarray(pidx), impl=impl)
    assert_close(np.asarray(got), np.asarray(want), atol=2e-3, rtol=2e-3,
                 name="paged short seqs")


@IMPLS
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_paged_quantized(rng, fmt, impl):
    """int8/fp8 pages + per-token scales == contiguous quantized decode."""
    B, Hq, Hkv, D, ps, pps = 2, 8, 2, 64, 64, 4
    lengths = np.array([256, 200], np.int32)
    q, k, v, kp, vp, pidx = _paged_setup(rng, B, Hq, Hkv, D, ps, pps, lengths)

    quant = quantize_int8_rowwise if fmt == "int8" else quantize_fp8_rowwise
    dequant = (dequantize_int8_rowwise if fmt == "int8"
               else dequantize_fp8_rowwise)
    kq, ks = quant(kp)
    vq, vs = quant(vp)
    # contiguous reference over the dequantized pool, gathered back
    kd = dequant(kq, ks)
    vd = dequant(vq, vs)
    k_contig = np.zeros_like(k)
    v_contig = np.zeros_like(v)
    for b in range(B):
        for pi in range(pps):
            sl = slice(pi * ps, (pi + 1) * ps)
            k_contig[b, :, sl] = kd[pidx[b, pi]]      # page-major pool
            v_contig[b, :, sl] = vd[pidx[b, pi]]
    want = flash_decode(jnp.asarray(q), jnp.asarray(k_contig),
                        jnp.asarray(v_contig), jnp.asarray(lengths))

    got = paged_decode(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                       jnp.asarray(lengths), jnp.asarray(pidx),
                       k_scale_pages=jnp.asarray(ks[..., 0]),
                       v_scale_pages=jnp.asarray(vs[..., 0]), impl=impl)
    assert_close(np.asarray(got), np.asarray(want), atol=2e-2, rtol=2e-2,
                 name=f"paged {fmt}")


@IMPLS
def test_layered_pool_matches_sliced(rng, impl):
    """Full 5-D page pool + layer index must bit-match the per-layer-slice
    call (the kernel offsets to the layer itself, so the engine never
    materializes a layer slice of the pool)."""
    L, B, Hq, Hkv, npg, ps, D = 3, 2, 8, 4, 16, 32, 64
    kp = jnp.asarray(rng.normal(size=(L, npg, Hkv, ps, D)), jnp.bfloat16)
    vp = jnp.asarray(rng.normal(size=(L, npg, Hkv, ps, D)), jnp.bfloat16)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), jnp.bfloat16)
    lens = jnp.asarray([70, 200], jnp.int32)
    pidx = jnp.asarray(
        rng.permutation(npg - 1)[:14].reshape(2, 7), jnp.int32)
    for li in (0, 2):
        want = paged_decode(q, kp[li], vp[li], lens, pidx, impl=impl)
        got = paged_decode(q, kp, vp, lens, pidx, layer=li, impl=impl)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("page_size", [16, 32, 64])
def test_page_sizes(rng, kv, page_size):
    """Kernel vs plain gather path across page sizes (7B serving uses 64)
    on a layered pool with GQA 8/2."""
    from ggml_cuda_experiments_tpu.models.llama import _quantize_rowwise
    L, B, Hq, Hkv, D, pps = 2, 2, 8, 2, 32, 4
    npg = B * pps + 1
    kp = jnp.asarray(rng.normal(size=(L, npg, Hkv, page_size, D)),
                     jnp.bfloat16)
    vp = jnp.asarray(rng.normal(size=(L, npg, Hkv, page_size, D)),
                     jnp.bfloat16)
    ks = vs = None
    if kv == "int8":
        kp, ks = _quantize_rowwise(kp)
        vp, vs = _quantize_rowwise(vp)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), jnp.bfloat16)
    lens = jnp.asarray([1, pps * page_size - 3], jnp.int32)
    pidx = jnp.asarray(rng.permutation(npg - 1)[:B * pps].reshape(B, pps),
                       jnp.int32)
    kw = dict(k_scale_pages=ks, v_scale_pages=vs, layer=1)
    got = paged_decode(q, kp, vp, lens, pidx, impl="kernel", **kw)
    want = paged_decode(q, kp, vp, lens, pidx, impl="xla", **kw)
    assert_close(np.asarray(got, np.float32), np.asarray(want, np.float32),
                 atol=3e-2, rtol=3e-2, name=f"paged ps={page_size} {kv}")
