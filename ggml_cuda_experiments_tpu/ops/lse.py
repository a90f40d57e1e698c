"""The associative (O, M, S) log-sum-exp combine — the load-bearing primitive.

The reference implements this merge four separate times at different scopes:
cross-warp inside ``flash_attn_ext_f16`` (/root/reference/src/flash-llama.h:
351-410), cross-warp in shared memory in ``flash_attn_row``
(/root/reference/src/flash_row_float.h:115-135), cross-KV-block in
``fa_reduce`` (/root/reference/src/flash_row_float.h:429-471), and per-thread
in the vendored xformers kernel (/root/reference/src/misc/attention.cu:
251-272). Here it is written ONCE as a pure, associative function and reused
at every level:

- inside Pallas kernels (per-grid-step accumulator update),
- across split-KV partials on one chip (``ops/flash_decode.py``),
- across chips for context-parallel / ring attention
  (``parallel/ring_attention.py``) via ``jax.lax`` collectives.

A partial is (o, m, s): un-normalized output o = sum_j exp(x_j - m) v_j,
running max m, running denominator s = sum_j exp(x_j - m). The combine is

    m'  = max(m_a, m_b)
    s'  = s_a * exp(m_a - m') + s_b * exp(m_b - m')
    o'  = o_a * exp(m_a - m') + o_b * exp(m_b - m')

which is associative and commutative (property-tested in
``tests/test_lse.py``), so any tiling/ordering of KV blocks gives the same
result — the mathematical fact all flash decoding rests on.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class AttnPartial(NamedTuple):
    """Partial attention state over some subset of KV positions.

    o: [..., D]  un-normalized weighted values, float32
    m: [..., 1]  running max of logits, float32
    s: [..., 1]  running sum of exp(logit - m), float32
    """

    o: jax.Array
    m: jax.Array
    s: jax.Array


def lse_identity(o_shape, dtype=jnp.float32) -> AttnPartial:
    """Identity element: m = -inf, s = 0, o = 0."""
    o = jnp.zeros(o_shape, dtype)
    m = jnp.full((*o_shape[:-1], 1), -jnp.inf, dtype)
    s = jnp.zeros((*o_shape[:-1], 1), dtype)
    return AttnPartial(o, m, s)


def lse_combine(a: AttnPartial, b: AttnPartial) -> AttnPartial:
    """Associative combine of two partial attention states."""
    m = jnp.maximum(a.m, b.m)
    # exp(-inf - -inf) would be NaN; guard the all-masked case.
    ea = jnp.where(a.m == -jnp.inf, 0.0, jnp.exp(a.m - m))
    eb = jnp.where(b.m == -jnp.inf, 0.0, jnp.exp(b.m - m))
    s = a.s * ea + b.s * eb
    o = a.o * ea + b.o * eb
    return AttnPartial(o, m, s)


def lse_combine_stacked(parts: AttnPartial, axis: int = 0) -> AttnPartial:
    """Fold a stacked array of partials along ``axis`` into one partial.

    Log-depth tree fold (the combine is associative): n splits cost
    ceil(log2 n) vectorized combines instead of a serial n-step loop, so
    large split counts (long-context split-KV) stay cheap."""
    p = AttnPartial(*(jnp.moveaxis(f, axis, 0) for f in parts))
    n = p.o.shape[0]
    while n > 1:
        half = n // 2
        even = AttnPartial(*(f[0:2 * half:2] for f in p))
        odd = AttnPartial(*(f[1:2 * half:2] for f in p))
        comb = lse_combine(even, odd)
        if n % 2:
            comb = AttnPartial(*(jnp.concatenate([c, f[-1:]], axis=0)
                                 for c, f in zip(comb, p)))
        p = comb
        n = p.o.shape[0]
    return AttnPartial(p.o[0], p.m[0], p.s[0])


def lse_combine_axis(p: AttnPartial, axis_name: str) -> AttnPartial:
    """Combine partials held by the devices of a mesh axis (context
    parallelism): the cross-chip form of the same merge, via pmax + psum
    collectives (one all-reduce hop; boom guide §15 approach 2)."""
    m = jax.lax.pmax(p.m, axis_name)
    alpha = jnp.where(p.m == -jnp.inf, 0.0, jnp.exp(p.m - m))
    s = jax.lax.psum(p.s * alpha, axis_name)
    o = jax.lax.psum(p.o * alpha, axis_name)
    return AttnPartial(o, m, s)


def lse_finalize(p: AttnPartial, out_dtype=None) -> jax.Array:
    """Normalize a partial into the attention output: o / s.

    Zero-length (fully masked) rows produce 0, matching the oracle's
    convention, instead of NaN.
    """
    s = jnp.where(p.s == 0.0, 1.0, p.s)
    out = p.o / s
    if out_dtype is not None:
        out = out.astype(out_dtype)
    return out
