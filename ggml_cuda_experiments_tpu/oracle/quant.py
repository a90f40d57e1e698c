"""GGML-style block quantization reference (NumPy, executable specification).

The reference repo contains no quantization, but the driver's north star
(BASELINE.json) mandates GGML block-quant (Q4_0 / Q4_K / Q8_0) weight-only
dequantization fused into matmul/matvec. This module is the *oracle*: it
defines the exact quantize/dequantize semantics that the Pallas kernels in
``ops/quant_matmul.py`` must reproduce bit-for-bit at dequant time.

Layout choice (struct-of-arrays):
GGML stores arrays of per-block C structs (34-byte blocks etc.). Interleaved
structs are hostile to XLA tiling and vector loads, so we store each field as its own
dense array ("planar" layout) with identical numerical semantics:

- Q8_0  (32-elem blocks, 8-bit):      qs int8  [..., N]
                                      d  f32   [..., N/32]  (fp16-rounded)
- Q4_0  (32-elem blocks, 4-bit):      qs uint8 [..., N/2]  (nibble-packed)
                                      d  f32   [..., N/32]  (fp16-rounded)
- Q4_K  (256-elem superblocks, 4.5-bit): asymmetric 4-bit with 6-bit
  per-32-subblock scales/mins quantized against fp16 superblock (d, dmin):
                                      qs   uint8 [..., N/2]
                                      sc   uint8 [..., N/32]   (6-bit, 0..63)
                                      mn   uint8 [..., N/32]   (6-bit, 0..63)
                                      d    f32   [..., N/256]  (fp16-rounded)
                                      dmin f32   [..., N/256]  (fp16-rounded)

Nibble packing is per-32-block planar, like GGML's Q4_0 (byte j of a block
holds element j in the low nibble and element j+16 in the high nibble): a
block's 32 values unpack with one reshape + two masks + one concat — no
cross-element shuffles.

Dequant formulas (the contract the kernels implement):
    Q8_0:  x = d * q                        q in [-127, 127]
    Q4_0:  x = d * (q - 8)                  q in [0, 15]
    Q4_K:  x = (d * sc) * q - (dmin * mn)   q in [0, 15], per 32-subblock
    Q6_K:  x = (d * sc) * (q - 32)          q in [0, 63], per 16-subblock
"""

from __future__ import annotations

import dataclasses

import numpy as np

np_div = lambda a, b: np.divide(a, b, out=np.zeros_like(a), where=(b != 0))

QK = 32          # elements per quantization block (GGML's QK8_0 / QK4_0)
QK_K = 256       # elements per Q4_K superblock

_F16 = np.float16


def _f16_round(x: np.ndarray) -> np.ndarray:
    """Round scale factors through fp16, as GGML stores them in fp16."""
    return x.astype(_F16).astype(np.float32)


# ---------------------------------------------------------------------------
# packing helpers (per-32-block planar nibbles)
# ---------------------------------------------------------------------------

def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """[..., nb, 32] uint8 (values 0..15) -> [..., nb, 16] packed uint8."""
    lo = q[..., :16]
    hi = q[..., 16:]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """[..., nb, 16] packed uint8 -> [..., nb, 32] uint8 (values 0..15)."""
    lo = packed & np.uint8(0x0F)
    hi = packed >> 4
    return np.concatenate([lo, hi], axis=-1)


# ---------------------------------------------------------------------------
# Q8_0
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Q8_0:
    """Planar Q8_0 tensor: per-32-block absmax int8 quantization."""
    qs: np.ndarray   # int8, shape [..., N]
    d: np.ndarray    # float32 (fp16-rounded), shape [..., N // 32]

    shape: tuple     # logical float shape

    @property
    def bits_per_weight(self) -> float:
        return 8 + 16 / QK


def quantize_q8_0(x: np.ndarray) -> Q8_0:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK == 0, f"last dim {n} must be a multiple of {QK}"
    xb = x.reshape(*lead, n // QK, QK)
    amax = np.max(np.abs(xb), axis=-1)
    d = _f16_round(amax / 127.0)
    inv_d = np_div(np.ones_like(d), d)
    q = np.clip(np.round(xb * inv_d[..., None]), -127, 127).astype(np.int8)
    return Q8_0(qs=q.reshape(*lead, n), d=d, shape=tuple(x.shape))


def dequantize_q8_0(t: Q8_0) -> np.ndarray:
    *lead, n = t.shape
    q = t.qs.reshape(*lead, n // QK, QK).astype(np.float32)
    return (q * t.d[..., None]).reshape(t.shape)


# ---------------------------------------------------------------------------
# Q4_0
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Q4_0:
    """Planar Q4_0 tensor: per-32-block symmetric 4-bit quantization."""
    qs: np.ndarray   # uint8 packed nibbles, shape [..., N // 2]
    d: np.ndarray    # float32 (fp16-rounded), shape [..., N // 32]
    shape: tuple

    @property
    def bits_per_weight(self) -> float:
        return 4 + 16 / QK


def quantize_q4_0(x: np.ndarray) -> Q4_0:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK == 0
    xb = x.reshape(*lead, n // QK, QK)
    # GGML picks the signed value with max magnitude and divides by -8 so the
    # extreme value maps to q=0 (after +8 offset) exactly.
    idx = np.argmax(np.abs(xb), axis=-1, keepdims=True)
    maxv = np.take_along_axis(xb, idx, axis=-1)[..., 0]
    d = _f16_round(maxv / -8.0)
    inv_d = np_div(np.ones_like(d), d)
    q = np.clip(np.round(xb * inv_d[..., None]) + 8, 0, 15).astype(np.uint8)
    return Q4_0(qs=pack_nibbles(q).reshape(*lead, n // 2), d=d,
                shape=tuple(x.shape))


def dequantize_q4_0(t: Q4_0) -> np.ndarray:
    *lead, n = t.shape
    packed = t.qs.reshape(*lead, n // QK, QK // 2)
    q = unpack_nibbles(packed).astype(np.float32) - 8.0
    return (q * t.d[..., None]).reshape(t.shape)


# ---------------------------------------------------------------------------
# Q4_K
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Q4_K:
    """Planar Q4_K tensor: asymmetric 4-bit, 6-bit sub-scales per superblock.

    x ≈ (d * sc_j) * q - (dmin * mn_j) for 32-element sub-block j of each
    256-element superblock.
    """
    qs: np.ndarray    # uint8 packed nibbles  [..., N // 2]
    sc: np.ndarray    # uint8 6-bit scales    [..., N // 32]
    mn: np.ndarray    # uint8 6-bit mins      [..., N // 32]
    d: np.ndarray     # float32 (fp16-rounded) [..., N // 256]
    dmin: np.ndarray  # float32 (fp16-rounded) [..., N // 256]
    shape: tuple

    @property
    def bits_per_weight(self) -> float:
        # nibbles + sc/mn stored as 8-bit planes + fp16 d/dmin per superblock
        return 4 + (8 + 8) / QK + (16 + 16) / QK_K


def quantize_q4_k(x: np.ndarray) -> Q4_K:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK_K == 0, f"last dim {n} must be a multiple of {QK_K}"
    nsb = n // QK_K                    # superblocks
    xb = x.reshape(*lead, nsb, 8, QK)  # 8 sub-blocks of 32 per superblock

    # per-sub-block asymmetric range: x in [mn_f, mx_f], x ≈ scale*q + mn_f
    mn_f = np.minimum(np.min(xb, axis=-1), 0.0)     # mins are <= 0 form
    mx_f = np.maximum(np.max(xb, axis=-1), 0.0)
    scale_f = (mx_f - mn_f) / 15.0                  # [..., nsb, 8]
    neg_mn = -mn_f                                   # >= 0

    # quantize sub-scales/mins to 6 bits against superblock maxima
    d = _f16_round(np.max(scale_f, axis=-1) / 63.0)          # [..., nsb]
    dmin = _f16_round(np.max(neg_mn, axis=-1) / 63.0)        # [..., nsb]
    inv_d = np_div(np.ones_like(d), d)
    inv_dmin = np_div(np.ones_like(dmin), dmin)
    sc = np.clip(np.round(scale_f * inv_d[..., None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.round(neg_mn * inv_dmin[..., None]), 0, 63).astype(np.uint8)

    # quantize values against the *decoded* scales (so dequant inverts exactly)
    eff_scale = d[..., None] * sc.astype(np.float32)          # [..., nsb, 8]
    eff_min = dmin[..., None] * mn.astype(np.float32)
    inv_s = np_div(np.ones_like(eff_scale), eff_scale)
    q = np.clip(np.round((xb + eff_min[..., None]) * inv_s[..., None]), 0, 15)
    q = q.astype(np.uint8)

    return Q4_K(
        qs=pack_nibbles(q.reshape(*lead, n // QK, QK)).reshape(*lead, n // 2),
        sc=sc.reshape(*lead, n // QK),
        mn=mn.reshape(*lead, n // QK),
        d=d, dmin=dmin, shape=tuple(x.shape),
    )


def dequantize_q4_k(t: Q4_K) -> np.ndarray:
    *lead, n = t.shape
    nsb = n // QK_K
    packed = t.qs.reshape(*lead, n // QK, QK // 2)
    q = unpack_nibbles(packed).astype(np.float32)             # [..., nb, 32]
    sc = t.sc.reshape(*lead, nsb, 8).astype(np.float32)
    mn = t.mn.reshape(*lead, nsb, 8).astype(np.float32)
    eff_scale = (t.d[..., None] * sc).reshape(*lead, n // QK)
    eff_min = (t.dmin[..., None] * mn).reshape(*lead, n // QK)
    x = q * eff_scale[..., None] - eff_min[..., None]
    return x.reshape(t.shape)


# ---------------------------------------------------------------------------
# Q6_K
# ---------------------------------------------------------------------------

QK6 = 16         # elements per Q6_K scale block (16 per 256-superblock)


@dataclasses.dataclass
class Q6_K:
    """Planar Q6_K tensor: symmetric 6-bit, int8 scales per 16-element
    sub-block of a 256-element superblock (llama.cpp stores output heads
    and attn_v in Q6_K for the *_K_M mixes).

    x ≈ (d * sc_j) * (q - 32) for 16-element sub-block j; q in [0, 63].
    The oracle keeps q unpacked (one uint8 per element); the GGML ql/qh
    bit-packing lives in utils/gguf.py and the device packing in
    ops/quant_matmul.py.
    """
    qs: np.ndarray   # uint8 values 0..63 (= q + 32), shape [..., N]
    sc: np.ndarray   # int8 sub-scales, shape [..., N // 16]
    d: np.ndarray    # float32 (fp16-rounded), shape [..., N // 256]
    shape: tuple

    @property
    def bits_per_weight(self) -> float:
        # = GGML's 210 bytes / 256 elements = 6.5625
        return 6 + 8 / QK6 + 16 / QK_K


def quantize_q6_k(x: np.ndarray) -> Q6_K:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK_K == 0, f"last dim {n} must be a multiple of {QK_K}"
    nsb = n // QK_K
    xb = x.reshape(*lead, nsb, QK_K // QK6, QK6)   # 16 sub-blocks of 16

    # per-sub-block signed scale: the max-|x| value maps to q = -32 exactly
    idx = np.argmax(np.abs(xb), axis=-1, keepdims=True)
    maxv = np.take_along_axis(xb, idx, axis=-1)[..., 0]
    scale_f = maxv / -32.0                          # [..., nsb, 16]

    d = _f16_round(np.max(np.abs(scale_f), axis=-1) / 127.0)   # [..., nsb]
    inv_d = np_div(np.ones_like(d), d)
    sc = np.clip(np.round(scale_f * inv_d[..., None]),
                 -127, 127).astype(np.int8)

    # quantize against the decoded scale so dequant inverts exactly
    eff = d[..., None] * sc.astype(np.float32)      # [..., nsb, 16]
    inv_s = np_div(np.ones_like(eff), eff)
    q = np.clip(np.round(xb * inv_s[..., None]), -32, 31) + 32
    return Q6_K(
        qs=q.astype(np.uint8).reshape(*lead, n),
        sc=sc.reshape(*lead, n // QK6),
        d=d, shape=tuple(x.shape),
    )


def dequantize_q6_k(t: Q6_K) -> np.ndarray:
    *lead, n = t.shape
    nsb = n // QK_K
    q = t.qs.reshape(*lead, n // QK6, QK6).astype(np.float32) - 32.0
    sc = t.sc.reshape(*lead, nsb, QK_K // QK6).astype(np.float32)
    eff = (t.d[..., None] * sc).reshape(*lead, n // QK6)
    return (q * eff[..., None]).reshape(t.shape)


# ---------------------------------------------------------------------------
# INT8 per-row (KV-cache) quantization — used by the quantized KV cache
# ---------------------------------------------------------------------------

def quantize_int8_rowwise(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-last-axis absmax int8 quantization: returns (qs int8, scale f32)."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = amax / 127.0
    inv = np_div(np.ones_like(scale), scale)
    q = np.clip(np.round(x * inv), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8_rowwise(qs: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return qs.astype(np.float32) * scale


FP8_MAX = 448.0     # float8_e4m3fn largest finite value


def quantize_fp8_rowwise(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-last-axis absmax float8_e4m3 quantization: returns
    (qs f8_e4m3fn, scale f32). The per-row scale maps the absmax to the f8
    dynamic range; f8 keeps ~3 mantissa bits vs int8's uniform grid, so
    small-magnitude entries quantize relatively better and large ones
    worse — the usual e4m3-KV trade."""
    import ml_dtypes
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = amax / FP8_MAX
    inv = np_div(np.ones_like(scale), scale)
    q = (x * inv).astype(ml_dtypes.float8_e4m3fn)
    return q, scale.astype(np.float32)


def dequantize_fp8_rowwise(qs: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return qs.astype(np.float32) * scale


FORMATS = {
    "q8_0": (quantize_q8_0, dequantize_q8_0),
    "q4_0": (quantize_q4_0, dequantize_q4_0),
    "q4_k": (quantize_q4_k, dequantize_q4_k),
    "q6_k": (quantize_q6_k, dequantize_q6_k),
}
