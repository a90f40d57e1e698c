"""Split-KV flash decode: one query token per sequence against a KV cache.

The reference's flash-decoding pipeline (``flash_attn_row`` + ``fa_reduce``,
/root/reference/src/flash_row_float.h) carried over to Hopper through
Pallas' Triton route:

- Grid (B, Hkv, splits). Each block owns one KV head of one sequence and an
  equal share of that sequence's *valid* KV blocks (the share is computed
  from the length inside the kernel, so padding past the length is never
  read). It loops over its range in ``block_k`` steps with an online
  softmax, and writes an un-normalized (O, M, S) partial — the reference's
  per-block temporal buffer.
- The GQA head group is the M dimension of the tensor-core dots: q [B, Hq,
  D] is viewed as [B, Hkv, G, D] and padded to 16 rows, so QK^T is a dense
  [16, D] x [D, block_k] dot instead of the reference's 16-fold replicated
  query (flash_row_float.h:21-38).
- int8 / fp8 K/V with per-token scales: the payload is converted to bf16 in
  registers and the scales are applied to the score and probability rows.
- ``fa_reduce`` is ``lse_combine_stacked`` (ops/lse.py) in XLA over the
  split axis.
- The kernel takes the whole stacked cache [L, B, Hkv, S, D] and the layer
  index as operands and offsets into it itself: an XLA slice in front of a
  custom call would copy the layer (16 MB per layer at 7B, S=2048).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ggml_cuda_experiments_tpu.ops.lse import (
    AttnPartial, lse_combine_stacked, lse_finalize)
from ggml_cuda_experiments_tpu.utils import platform

GPU_IMPL = "kernel"

DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

_MIN_ROWS = 16       # smallest tensor-core tile M that pl.dot accepts
_TARGET_BLOCKS = 256  # about two blocks per SM on a 132-SM card


def decode_plan(batch: int, n_kv_heads: int, seq: int,
                kv_splits: int | None = None,
                block_k: int | None = None) -> tuple[int, int]:
    """(block_k, splits): the largest power-of-two block (<= 64) dividing
    the cache length, and enough splits for about 2 blocks per SM."""
    bk = block_k or next(c for c in (64, 32, 16) if seq % c == 0)
    assert seq % bk == 0 and bk >= 16, (seq, bk)
    if kv_splits is None:
        kv_splits = 1
        while (batch * n_kv_heads * kv_splits < _TARGET_BLOCKS
               and kv_splits * 2 <= seq // bk):
            kv_splits *= 2
    return bk, kv_splits


def _group_rows(g: int) -> int:
    return max(_MIN_ROWS, 1 << (g - 1).bit_length())


def _online_softmax_step(q, k, v, kscale, vscale, pos0, length, scale,
                         carry):
    """One KV block of the online softmax. q [Gp, D]; k, v [bk, D];
    kscale / vscale [bk] or None. Returns the updated (o, m, l)."""
    o, m, l = carry
    bk = k.shape[0]
    if kscale is not None:
        k = k.astype(jnp.bfloat16)
        v = v.astype(jnp.bfloat16)
        s = pl.dot(q.astype(jnp.bfloat16), k, trans_b=True)
        s = s * (kscale.astype(jnp.float32) * scale)[None, :]
    else:
        s = pl.dot(q, k.astype(q.dtype), trans_b=True) * scale
    kpos = pos0 + jnp.arange(bk, dtype=jnp.int32)
    s = jnp.where(kpos[None, :] < length, s, DEFAULT_MASK_VALUE)
    m_new = jnp.maximum(m, jnp.max(s, axis=1))
    alpha = jnp.exp(m - m_new)
    p = jnp.exp(s - m_new[:, None])
    l = l * alpha + jnp.sum(p, axis=1)
    if vscale is not None:
        p = p * vscale.astype(jnp.float32)[None, :]
    o = o * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
    return o, m_new, l


def _decode_kernel(len_ref, layer_ref, q_ref, k_ref, v_ref, *rest,
                   scale: float, bk: int, splits: int, quantized: bool,
                   layered: bool):
    if quantized:
        ks_ref, vs_ref, o_ref, m_ref, l_ref = rest
    else:
        o_ref, m_ref, l_ref = rest
    sp = pl.program_id(2)
    length = len_ref[0]
    n_blk = pl.cdiv(length, bk)
    per = pl.cdiv(n_blk, splits)
    start = sp * per
    end = jnp.minimum(start + per, n_blk)
    lyr = (layer_ref[0],) if layered else ()
    q = q_ref[...]
    gp, d = q.shape

    def body(i, carry):
        pos0 = i * bk
        kv_idx = lyr + (pl.ds(pos0, bk), slice(None))
        sc_idx = lyr + (pl.ds(pos0, bk),)
        return _online_softmax_step(
            q, k_ref[kv_idx], v_ref[kv_idx],
            ks_ref[sc_idx] if quantized else None,
            vs_ref[sc_idx] if quantized else None,
            pos0, length, scale, carry)

    o, m, l = jax.lax.fori_loop(
        start, end, body,
        (jnp.zeros((gp, d), jnp.float32),
         jnp.full((gp,), -jnp.inf, jnp.float32),
         jnp.zeros((gp,), jnp.float32)))
    o_ref[...] = o
    m_ref[...] = m
    l_ref[...] = l


def _decode_partial_kernel(q, k, v, lengths, k_scale, v_scale, scale,
                           layer, kv_splits, block_k) -> AttnPartial:
    """Kernel path -> merged partial (o [B, Hkv, G, D], m/s [..., 1])."""
    B, Hq, D = q.shape
    layered = k.ndim == 5
    L, _, Hkv, S, _ = k.shape if layered else (1, *k.shape)
    G = Hq // Hkv
    gp = _group_rows(G)
    bk, splits = decode_plan(B, Hkv, S, kv_splits, block_k)
    quantized = k_scale is not None

    qg = jnp.pad(q.reshape(B, Hkv, G, D), ((0, 0), (0, 0), (0, gp - G),
                                            (0, 0)))
    lens = lengths.astype(jnp.int32).reshape(B, 1)
    lyr = jnp.asarray(layer if layered else 0, jnp.int32).reshape(1)
    lead = (L,) if layered else ()
    lead0 = (0,) if layered else ()
    kv_spec = pl.BlockSpec((*lead, None, None, S, D),
                           lambda b, h, s: (*lead0, b, h, 0, 0))
    sc_spec = pl.BlockSpec((*lead, None, None, S),
                           lambda b, h, s: (*lead0, b, h, 0))
    in_specs = [
        pl.BlockSpec((None, 1), lambda b, h, s: (b, 0)),
        pl.BlockSpec((1,), lambda b, h, s: (0,)),
        pl.BlockSpec((None, None, gp, D), lambda b, h, s: (b, h, 0, 0)),
        kv_spec, kv_spec,
    ]
    args = [lens, lyr, qg, k, v]
    if quantized:
        in_specs += [sc_spec, sc_spec]
        args += [k_scale, v_scale]
    o, m, l = pl.pallas_call(
        functools.partial(_decode_kernel, scale=scale, bk=bk, splits=splits,
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
        name="flash_decode",
    )(*args)
    parts = AttnPartial(o=o[:, :, :, :G], m=m[:, :, :, :G, None],
                        s=l[:, :, :, :G, None])
    return lse_combine_stacked(parts, axis=2)


def _decode_partial_xla(q, k, v, lengths, k_scale, v_scale, scale,
                        layer) -> AttnPartial:
    """Plain path: full read of the (layer of the) cache, masked softmax."""
    if k.ndim == 5:
        pick = lambda a: jax.lax.dynamic_index_in_dim(a, layer, 0, False)
        k, v = pick(k), pick(v)
        if k_scale is not None:
            k_scale, v_scale = pick(k_scale), pick(v_scale)
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    prec = (jax.lax.Precision.HIGHEST if q.dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    qg = q.reshape(B, Hkv, G, D).astype(jnp.float32)
    kf, vf = k.astype(jnp.float32), v.astype(jnp.float32)
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    s = jnp.einsum("bhgd,bhsd->bhgs", qg, kf, precision=prec) * scale
    valid = jnp.arange(S)[None, :] < lengths[:, None]         # [B, S]
    s = jnp.where(valid[:, None, None], s, -jnp.inf)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.where(valid[:, None, None],
                  jnp.exp(s - jnp.where(jnp.isfinite(m), m, 0.0)), 0.0)
    o = jnp.einsum("bhgs,bhsd->bhgd", p, vf, precision=prec)
    return AttnPartial(o=o, m=m, s=jnp.sum(p, axis=-1, keepdims=True))


def choose_impl(impl: str | None = None) -> str:
    return platform.resolve_impl(impl, GPU_IMPL, ("kernel", "xla"))


@functools.partial(
    jax.jit,
    static_argnames=("scale", "kv_splits", "block_k", "return_partial",
                     "impl"),
)
def flash_decode(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    lengths: jax.Array | None = None,
    *,
    k_scale: jax.Array | None = None,
    v_scale: jax.Array | None = None,
    scale: float | None = None,
    kv_splits: int | None = None,
    block_k: int | None = None,
    return_partial: bool = False,
    layer: jax.Array | int | None = None,
    impl: str | None = None,
):
    """Single-token attention against a KV cache, split-KV parallel.

    q: [B, Hq, D] (the current token's query per sequence)
    k, v: [B, Hkv, S, D] KV cache (S = allocated cache length), OR the FULL
        stacked cache [L, B, Hkv, S, D] together with ``layer``.
    lengths: [B] int32 valid prefix per sequence (>= 1; defaults to S)
    k_scale, v_scale: per-token f32 scales ([(L,) B, Hkv, S]) for int8 /
        fp8 caches.
    Returns O [B, Hq, D] in q's dtype, or with ``return_partial`` the
    un-normalized AttnPartial (o [B, Hq, D], m / s [B, Hq, 1]) for
    cross-device merging. ``impl``: "kernel", "xla" or None.
    """
    B, Hq, D = q.shape
    layered = k.ndim == 5
    assert layered == (layer is not None), \
        "pass `layer` iff k/v carry a leading layer dimension"
    assert (k_scale is None) == (v_scale is None), \
        "k_scale and v_scale must be given together"
    S = k.shape[-2]
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    if lengths is None:
        lengths = jnp.full((B,), S, jnp.int32)
    if choose_impl(impl) == "kernel":
        part = _decode_partial_kernel(q, k, v, lengths, k_scale, v_scale,
                                      scale, layer, kv_splits, block_k)
    else:
        part = _decode_partial_xla(q, k, v, lengths, k_scale, v_scale,
                                   scale, layer)
    part = AttnPartial(o=part.o.reshape(B, Hq, D),
                       m=part.m.reshape(B, Hq, 1),
                       s=part.s.reshape(B, Hq, 1))
    if return_partial:
        return part
    return lse_finalize(part, out_dtype=q.dtype)
