"""Prefill attention: O = softmax(Q K^T * scale + mask) V with GQA.

The reference's ``flash_attn_ext_f16`` (/root/reference/src/flash-llama.h:
5-437) is a hand-written fused kernel. On Hopper the library route covers
it: ``jax.nn.dot_product_attention(implementation="cudnn")`` calls cuDNN's
fused flash attention (online softmax, causal tile skipping, GQA). The plain
path below is the same math in ``jax.numpy`` (the CPU implementation, and
the card's for what cuDNN does not take: float32 inputs, arbitrary additive
masks, a causal window whose queries are not the whole context, and the
log-sum-exp residuals ring attention merges).

Causality follows the decode convention: the Sq queries are the *last* Sq
positions of the Sk-long context (query i attends kv j iff j <= i + Sk - Sq).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ggml_cuda_experiments_tpu.utils import platform

# Implementation on the card where cuDNN applies (PERF.md has the timing).
GPU_IMPL = "cudnn"

# Finite stand-in for -inf: exp underflows to 0 without inf - inf NaNs
# (see boom guide §4 / flash-llama.h NaN guard :258).
DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def cudnn_supported(q: jax.Array, k: jax.Array, mask, causal: bool,
                    return_residuals: bool) -> bool:
    """Shapes and options cuDNN's fused attention takes here."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    return (q.dtype in (jnp.bfloat16, jnp.float16) and k.dtype == q.dtype
            and mask is None and not return_residuals
            and (not causal or sq == sk) and d % 8 == 0 and d <= 128)


def choose_impl(q, k, mask=None, causal=False, return_residuals=False,
                impl: str | None = None) -> str:
    ok = cudnn_supported(q, k, mask, causal, return_residuals)
    impl = platform.resolve_impl(impl, GPU_IMPL if ok else "xla",
                                 ("cudnn", "xla"))
    if impl == "cudnn" and not ok:
        raise ValueError("cuDNN attention does not take this call")
    return impl


def _attention_xla(q, k, v, mask, scale, causal, kv_lengths):
    """Plain jnp attention; returns (o [B,Hq,Sq,D] f32, lse [B,Hq,Sq])."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    r = Hq // Hkv
    prec = (jax.lax.Precision.HIGHEST if q.dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    qg = q.reshape(B, Hkv, r, Sq, D)
    s = jnp.einsum("bhrqd,bhkd->bhrqk", qg, k.astype(q.dtype),
                   preferred_element_type=jnp.float32,
                   precision=prec) * scale
    if mask is not None:
        m = jnp.asarray(mask, jnp.float32)
        m = jnp.broadcast_to(m, (*m.shape[:2], Sq, Sk))
        m = (m.reshape(m.shape[0], Hkv, r, Sq, Sk) if m.shape[1] == Hq
             else m[:, :, None])
        s = s + m
    qpos = jnp.arange(Sq)[:, None] + (Sk - Sq)
    kpos = jnp.arange(Sk)[None, :]
    if causal:
        s = jnp.where(kpos <= qpos, s, DEFAULT_MASK_VALUE)
    if kv_lengths is not None:
        valid = kpos[None] < kv_lengths[:, None, None]          # [B, 1, Sk]
        s = jnp.where(valid[:, None, None], s, DEFAULT_MASK_VALUE)
    mx = jnp.max(s, axis=-1, keepdims=True)
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)       # fully masked rows -> 0
    p = jnp.exp(s - mx)
    l = jnp.sum(p, axis=-1, keepdims=True)
    o = jnp.einsum("bhrqk,bhkd->bhrqd", p, v.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    o = o / jnp.where(l == 0.0, 1.0, l)
    lse = jnp.where(l == 0.0, -jnp.inf,
                    mx + jnp.log(jnp.where(l == 0.0, 1.0, l)))
    return o.reshape(B, Hq, Sq, D), lse[..., 0].reshape(B, Hq, Sq)


@functools.partial(
    jax.jit,
    static_argnames=("scale", "causal", "return_residuals", "impl"),
)
def attention(q: jax.Array, k: jax.Array, v: jax.Array,
              mask: jax.Array | None = None, *, scale: float | None = None,
              causal: bool = False, kv_lengths: jax.Array | None = None,
              return_residuals: bool = False, impl: str | None = None):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] with Hq % Hkv == 0 (GQA).
    mask: optional additive mask broadcastable from [B|1, Hq|1, Sq, Sk].
    kv_lengths: optional [B] int32; keys at or past it are masked.
    Returns O [B, Hq, Sq, D] in q's dtype; with ``return_residuals`` also
    lse = m + log(l) [B, Hq, Sq] (f32) for cross-shard merging.
    ``impl``: "cudnn", "xla", or None (``choose_impl``)."""
    B, Hq, Sq, D = q.shape
    assert Hq % k.shape[1] == 0, f"GQA needs Hq % Hkv == 0"
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    impl = choose_impl(q, k, mask, causal, return_residuals, impl)
    if impl == "cudnn":
        o = jax.nn.dot_product_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), scale=scale, is_causal=causal,
            key_value_seq_lengths=(None if kv_lengths is None else
                                   kv_lengths.astype(jnp.int32)),
            implementation="cudnn")
        return o.transpose(0, 2, 1, 3)
    o, lse = _attention_xla(q, k, v, mask, scale, causal, kv_lengths)
    o = o.astype(q.dtype)
    return (o, lse) if return_residuals else o
