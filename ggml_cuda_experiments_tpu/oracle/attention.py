"""Reference (oracle) attention math in pure NumPy.

The analog of the reference's CPU oracle:
- ``mulmat_ref``        ~ ``mulmat_cpu`` (/root/reference/src/utils.h:5-28),
  including the optional fp16-faithful round-trip of the A operand
  (utils.h:10-11) and the fused ``*scale + mask`` epilogue.
- ``online_softmax_ref`` ~ the single-pass online softmax recurrence
  (/root/reference/src/utils.h:30-49) shared by every GPU kernel in the
  reference; kept here as an executable specification of the recurrence that
  the Pallas kernels and the LSE merge must reproduce.
- ``attention_ref``     ~ the per-head oracle loop in ``test_llama`` /
  ``kernel_test`` (/root/reference/src/flash-matrix.cu:86-112,
  /root/reference/src/kernel_test.h:50-66): QK^T * scale + mask -> softmax ->
  P V, with GQA head broadcast (q head h uses kv head h // (Hq//Hkv),
  kernel_test.h:25-27,53).

Everything is float64-free on purpose: the oracle runs in float32 (optionally
simulating bf16 operand rounding) so tolerances reflect what the device kernels
can actually achieve.
"""

from __future__ import annotations

import numpy as np


def _round_through(x: np.ndarray, dtype) -> np.ndarray:
    """Round-trip ``x`` through a narrower dtype (bf16/fp16) back to f32.

    The analog of the reference oracle's fp16 round-trip of the A operand
    (utils.h:10-11) that makes the CPU result bit-comparable with tensor-core
    math. The kernels here feed bf16 to the tensor cores, so the default
    faithful dtype is bfloat16.
    """
    if dtype is None:
        return np.asarray(x, np.float32)
    import ml_dtypes  # ships with jax

    return np.asarray(x).astype(dtype).astype(np.float32)


def mulmat_ref(
    a: np.ndarray,
    b: np.ndarray,
    *,
    b_transposed: bool = False,
    scale: float = 1.0,
    mask: np.ndarray | None = None,
    operand_dtype=None,
) -> np.ndarray:
    """C = (A @ B) * scale + mask, accumulated in float32.

    ``b_transposed`` means B is stored [N, K] and used as B^T, matching the
    reference's "matrix B transposed" overload (utils.h:5-16).
    ``operand_dtype`` optionally rounds both operands through a narrow dtype
    first (bf16 for tensor-core-faithful comparison).
    """
    a = _round_through(a, operand_dtype)
    b = _round_through(b, operand_dtype)
    if b_transposed:
        c = a.astype(np.float32) @ b.astype(np.float32).T
    else:
        c = a.astype(np.float32) @ b.astype(np.float32)
    if scale != 1.0:
        c = c * np.float32(scale)
    if mask is not None:
        c = c + mask.astype(np.float32)
    return c


def softmax_ref(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Plain numerically-stable softmax (two-pass)."""
    x = np.asarray(x, np.float32)
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def online_softmax_ref(x: np.ndarray) -> tuple[np.ndarray, np.float32, np.float32]:
    """Single-pass online softmax over a 1-D vector.

    Returns (probs, m, l) where m is the running max and l the running sum of
    exponentials — the exact recurrence of the reference oracle
    (utils.h:30-49) and of every flash kernel's inner loop:

        m' = max(m, x_i);  l' = l * exp(m - m') + exp(x_i - m')
    """
    x = np.asarray(x, np.float32)
    m = np.float32(-np.inf)
    l = np.float32(0.0)
    out = np.empty_like(x)
    for i, xi in enumerate(x):
        m_new = max(m, xi)
        l = l * np.exp(m - m_new) + np.exp(xi - m_new)
        m = m_new
        out[i] = xi
    # second (vector) pass to materialize probabilities given final (m, l)
    return np.exp(out - m) / l, m, l


def attention_ref(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    mask: np.ndarray | None = None,
    scale: float | None = None,
    causal: bool = False,
    operand_dtype=None,
) -> np.ndarray:
    """Full multi-head attention oracle with GQA broadcast.

    Shapes (batch-first layout):
        q:    [B, Hq,  Sq, D]
        k, v: [B, Hkv, Sk, D]
        mask: broadcastable to [B, Hq, Sq, Sk] (additive, -inf for masked)
    Returns O: [B, Hq, Sq, D] float32.

    GQA: q head h attends to kv head ``h // (Hq // Hkv)`` — the same indexing
    as the reference (kernel_test.h:53, flash_row_float.h:19).
    """
    q, k, v = (np.asarray(t) for t in (q, k, v))
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    assert Hq % Hkv == 0, f"GQA requires Hq % Hkv == 0, got {Hq}/{Hkv}"
    r = Hq // Hkv
    if scale is None:
        scale = 1.0 / np.sqrt(D)

    out = np.empty((B, Hq, Sq, D), np.float32)
    for b in range(B):
        for h in range(Hq):
            hk = h // r
            m = None
            if mask is not None:
                mm = np.broadcast_to(mask, (B, Hq, Sq, Sk))
                m = mm[b, h]
            s = mulmat_ref(
                q[b, h], k[b, hk], b_transposed=True, scale=scale, mask=m,
                operand_dtype=operand_dtype,
            )
            if causal:
                i = np.arange(Sq)[:, None]
                j = np.arange(Sk)[None, :]
                # queries are the *last* Sq positions of the Sk-long context
                s = np.where(j <= i + (Sk - Sq), s, -np.inf)
            p = softmax_ref(s, axis=-1)
            out[b, h] = mulmat_ref(p, v[b, hk], operand_dtype=operand_dtype)
    return out
