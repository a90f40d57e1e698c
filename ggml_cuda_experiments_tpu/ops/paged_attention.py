"""Paged-KV flash decode: single-token attention over a shared page pool.

The serving-time form of the split-KV decode (ops/flash_decode.py): the KV
cache lives in one page pool, each sequence owns a list of page indices,
and each kernel block loads its own page indices and then its pages, in
the same online-softmax loop as the contiguous decode. (On the reference
this staging is ``memcpy_async`` into shared memory,
/root/reference/src/flash_row_float.h:241-252; through Triton, the loop's
pipeline stages keep the next page's loads in flight.)

Layout: the pool is page-major across heads, ``[(L,) n_pages, Hkv,
page_size, D]`` — a page is the unit of allocation, and the kernel reads
it as stored (no transpose to JAX's head-major example layout per call).
Grid (B, Hkv, splits); a block owns one KV head of one sequence and an
equal share of its valid pages. int8 / fp8 pages carry per-token f32
scales ``[(L,) n_pages, Hkv, page_size]``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ggml_cuda_experiments_tpu.ops.flash_decode import (
    _decode_partial_xla, _group_rows, _online_softmax_step, _TARGET_BLOCKS)
from ggml_cuda_experiments_tpu.ops.lse import (
    AttnPartial, lse_combine_stacked, lse_finalize)
from ggml_cuda_experiments_tpu.utils import platform

GPU_IMPL = "kernel"


def paged_splits(batch: int, n_kv_heads: int, pages_per_seq: int) -> int:
    splits = 1
    while (batch * n_kv_heads * splits < _TARGET_BLOCKS
           and splits * 2 <= pages_per_seq):
        splits *= 2
    return splits


def _paged_kernel(len_ref, layer_ref, pt_ref, q_ref, k_ref, v_ref, *rest,
                  scale: float, ps: int, splits: int, quantized: bool,
                  layered: bool):
    if quantized:
        ks_ref, vs_ref, o_ref, m_ref, l_ref = rest
    else:
        o_ref, m_ref, l_ref = rest
    sp = pl.program_id(2)
    length = len_ref[0]
    n_pg = pl.cdiv(length, ps)
    per = pl.cdiv(n_pg, splits)
    start = sp * per
    end = jnp.minimum(start + per, n_pg)
    lyr = (layer_ref[0],) if layered else ()
    q = q_ref[...]
    gp, d = q.shape

    def body(i, carry):
        page = pt_ref[i]
        kv_idx = lyr + (page, slice(None), slice(None))
        sc_idx = lyr + (page, slice(None))
        return _online_softmax_step(
            q, k_ref[kv_idx], v_ref[kv_idx],
            ks_ref[sc_idx] if quantized else None,
            vs_ref[sc_idx] if quantized else None,
            i * ps, length, scale, carry)

    o, m, l = jax.lax.fori_loop(
        start, end, body,
        (jnp.zeros((gp, d), jnp.float32),
         jnp.full((gp,), -jnp.inf, jnp.float32),
         jnp.zeros((gp,), jnp.float32)))
    o_ref[...] = o
    m_ref[...] = m
    l_ref[...] = l


def _paged_partial_kernel(q, k_pages, v_pages, lengths, page_indices,
                          k_scale_pages, v_scale_pages, scale, layer,
                          kv_splits):
    B, Hq, D = q.shape
    layered = k_pages.ndim == 5
    L, P, Hkv, ps, _ = (k_pages.shape if layered else (1, *k_pages.shape))
    G = Hq // Hkv
    gp = _group_rows(G)
    pps = page_indices.shape[1]
    splits = kv_splits or paged_splits(B, Hkv, pps)
    quantized = k_scale_pages is not None
    assert ps >= 16 and ps & (ps - 1) == 0, f"page size {ps}: power of 2 >= 16"

    qg = jnp.pad(q.reshape(B, Hkv, G, D), ((0, 0), (0, 0), (0, gp - G),
                                            (0, 0)))
    lens = lengths.astype(jnp.int32).reshape(B, 1)
    lyr = jnp.asarray(layer if layered else 0, jnp.int32).reshape(1)
    lead = (L,) if layered else ()
    lead0 = (0,) if layered else ()
    kv_spec = pl.BlockSpec((*lead, P, None, ps, D),
                           lambda b, h, s: (*lead0, 0, h, 0, 0))
    sc_spec = pl.BlockSpec((*lead, P, None, ps),
                           lambda b, h, s: (*lead0, 0, h, 0))
    in_specs = [
        pl.BlockSpec((None, 1), lambda b, h, s: (b, 0)),
        pl.BlockSpec((1,), lambda b, h, s: (0,)),
        pl.BlockSpec((None, pps), lambda b, h, s: (b, 0)),
        pl.BlockSpec((None, None, gp, D), lambda b, h, s: (b, h, 0, 0)),
        kv_spec, kv_spec,
    ]
    args = [lens, lyr, page_indices.astype(jnp.int32), qg, k_pages, v_pages]
    if quantized:
        in_specs += [sc_spec, sc_spec]
        args += [k_scale_pages, v_scale_pages]
    o, m, l = pl.pallas_call(
        functools.partial(_paged_kernel, scale=scale, ps=ps, splits=splits,
                          quantized=quantized, layered=layered),
        grid=(B, Hkv, splits),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, gp, D),
                         lambda b, h, s: (b, h, s, 0, 0)),
            pl.BlockSpec((None, None, None, gp),
                         lambda b, h, s: (b, h, s, 0)),
            pl.BlockSpec((None, None, None, gp),
                         lambda b, h, s: (b, h, s, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, Hkv, splits, gp, D), jnp.float32),
            jax.ShapeDtypeStruct((B, Hkv, splits, gp), jnp.float32),
            jax.ShapeDtypeStruct((B, Hkv, splits, gp), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=platform.interpret(),
        name="paged_decode",
    )(*args)
    parts = AttnPartial(o=o[:, :, :, :G], m=m[:, :, :, :G, None],
                        s=l[:, :, :, :G, None])
    return lse_combine_stacked(parts, axis=2)


def gather_pages(pool: jax.Array, page_indices: jax.Array, layer=None
                 ) -> jax.Array:
    """Plain gather of each sequence's pages into a contiguous cache:
    pool [(L,) P, Hkv, ps, ...] -> [B, Hkv, pages*ps, ...]."""
    if layer is not None:
        pool = jax.lax.dynamic_index_in_dim(pool, layer, 0, False)
    g = pool[page_indices]                       # [B, pages, Hkv, ps, ...]
    g = jnp.moveaxis(g, 2, 1)                    # [B, Hkv, pages, ps, ...]
    return g.reshape(*g.shape[:2], -1, *g.shape[4:])


def choose_impl(impl: str | None = None) -> str:
    return platform.resolve_impl(impl, GPU_IMPL, ("kernel", "xla"))


@functools.partial(jax.jit, static_argnames=("scale", "kv_splits", "impl"))
def paged_decode(
    q: jax.Array,
    k_pages: jax.Array,
    v_pages: jax.Array,
    lengths: jax.Array,
    page_indices: jax.Array,
    *,
    k_scale_pages: jax.Array | None = None,
    v_scale_pages: jax.Array | None = None,
    scale: float | None = None,
    kv_splits: int | None = None,
    layer: jax.Array | int | None = None,
    impl: str | None = None,
) -> jax.Array:
    """Single-token attention over a paged KV cache.

    q:            [B, Hq, D]
    k/v_pages:    [n_pages, Hkv, page_size, D] shared page pool, OR the
                  full per-layer pool [L, n_pages, Hkv, page_size, D]
                  together with ``layer``
    lengths:      [B] int32 valid tokens per sequence (>= 1)
    page_indices: [B, pages_per_seq] int32 logical->physical page map
    k/v_scale_pages: [(L,) n_pages, Hkv, page_size] f32 for int8/fp8 pages
    Returns O [B, Hq, D] in q's dtype. ``impl``: "kernel" (Triton), "xla"
    (gather the pages, then the plain decode) or None.
    """
    B, Hq, D = q.shape
    layered = k_pages.ndim == 5
    assert layered == (layer is not None), \
        "pass `layer` iff the page pools carry a leading layer dimension"
    assert (k_scale_pages is None) == (v_scale_pages is None)
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    if choose_impl(impl) == "kernel":
        part = _paged_partial_kernel(q, k_pages, v_pages, lengths,
                                     page_indices, k_scale_pages,
                                     v_scale_pages, scale, layer, kv_splits)
    else:
        gl = functools.partial(gather_pages, page_indices=page_indices,
                               layer=layer)
        quantized = k_scale_pages is not None
        part = _decode_partial_xla(
            q, gl(k_pages), gl(v_pages), lengths,
            gl(k_scale_pages) if quantized else None,
            gl(v_scale_pages) if quantized else None, scale, None)
    part = AttnPartial(o=part.o.reshape(B, Hq, D),
                       m=part.m.reshape(B, Hq, 1),
                       s=part.s.reshape(B, Hq, 1))
    return lse_finalize(part, out_dtype=q.dtype)
