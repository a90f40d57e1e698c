"""Block-quantized linears (Q8_0 / Q4_0 / Q4_K / Q6_K): device layout, the
plain XLA path, and the fused dequant-matvec kernel for decode.

GGML-style weight-only block quantization, dequantized *inside* the matvec
so decode streams the stored bytes (4.5-8.5 bits per weight) from device
memory once, instead of a dense bf16 weight (16 bits). The reference repo has
no quant path; this is the driver-mandated extension (SURVEY.md §7 R8).

Stored layout: the "interleaved" column order
---------------------------------------------
Weight columns are stored permuted (a storage choice made once at load):

    device lane j  <->  logical element e = super*256 + pos8*32 + pos32
    (a hierarchical (K/256, 8, 32) -> (32, 8, K/256) transpose; a 2-level
    (K/32, 32) -> (32, K/32) version covers K % 256 != 0 for q8_0/q4_0)

Under this order the scale block of device lane j is ``j mod (K/32)``, and
the two lanes i and i + K/2 always share a block. For K % 4096 == 0 with
K > 4096 the interleave is *segment-local* (each 4096-element segment on its
own, the nibble halves separated globally), and byte-lane i's block is
``(i // 2048)*128 + i % 128``. ``_block_cols`` tabulates the block of every
byte-lane, so the kernel and the XLA path handle both orders with one table.

Because the order is only a permutation of K, a product needs x in the same
order: ``permute_activations`` reorders x once per call (a few KB).

Q4 nibble packing: byte i holds device lanes i (low nibble) and i + K/2
(high nibble, stored XOR 8 — "signed-friendly": the int8 value of the byte
is ``lo + 16*hi - 128``). Q8_0 stores lanes [0, K/2) and [K/2, K) as the two
halves of one int8 row, so every format has the same lo/hi lane pairing.

Q4_K encodings (``QuantLinear.enc``)
------------------------------------
``"e"`` ("Q4_K-E", default): sub-scales folded at load time into per-32-block
effective scales ``es = bf16(f32(d)*sc)`` and mins ``em = bf16(f32(dmin)*mn)``
— 5.0 bits/weight stored. ``"s6"`` (opt-in storage encoding, K % 4096 == 0):
the GGML-faithful 6-bit sub-scales one byte each plus bf16 superblock scales
(4.625 bits/weight); every product expands it to "e" first (``scales_to_e``).

Decode kernel (``_qmv_kernel``, Pallas through Triton)
------------------------------------------------------
In either order a row's K/2 byte-lanes form a [S, 16, kbl] grid in which
lane (s, t, c) has scale column s*kbl + c (S = 1 and kbl = K/32 for the
global interleave; kbl = 128 per segment for the segment-local one). Grid
(N / block_n, k_splits). Each block walks its share of the (s, c) columns
``cc`` at a time: it loads the [block_n, cc] scales once, the [block_n, 16,
cc] payload bytes that share them, dequantizes in registers, and multiplies
against x with ``pl.dot`` (x padded to 16 rows, the smallest tensor-core
tile), or for a single row of x with a multiply-add on the CUDA cores. The k_splits partial sums are added in XLA. Nothing but the
stored bytes crosses device memory.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
from ggml_cuda_experiments_tpu.utils import platform

QK = quant_ref.QK            # 32
QK_K = quant_ref.QK_K        # 256

# Implementation on the card for up to KERNEL_MAX_ROWS rows of x: the fused
# kernel, which beat XLA at 1-32 rows on the card (PERF.md; a 64-row tile
# no longer fits shared memory); else XLA's dequantize + cuBLAS bf16 dot
# (prefill, where the dequant is amortised over many rows).
GPU_IMPL = "kernel"
KERNEL_MAX_ROWS = 32
KERNEL_FMTS = ("q8_0", "q4_0", "q4_k")


# ---------------------------------------------------------------------------
# interleaved column order
# ---------------------------------------------------------------------------

# Segment size for the segment-local interleave (K > _SEG, K % _SEG == 0).
_SEG = 4096


def _n_segs(k: int) -> int:
    return k // _SEG if (k % _SEG == 0 and k > _SEG) else 1


@functools.cache
def _perm(k: int) -> np.ndarray:
    """perm[j] = logical element index stored at device lane j.

    For K % 4096 == 0 with K > 4096 the order is *byte-split
    segment-local*: each 4096-element segment is independently interleaved
    (as if K were 4096), and the two nibble halves of every segment are
    separated globally — lanes [0, K/2) are the segments' low halves in
    segment order, lanes [K/2, K) the high halves. Byte i of the packed
    payload then still pairs lanes (i, i + K/2), and those two lanes still
    share a scale block."""
    assert k % QK == 0, f"K={k} must be a multiple of {QK}"
    s = _n_segs(k)
    if s > 1:
        chunks = np.stack([_perm(_SEG) + c * _SEG for c in range(s)])
        return (chunks.reshape(s, 2, _SEG // 2)
                .transpose(1, 0, 2).reshape(k))   # byte-split halves
    if k % QK_K == 0:
        ks = k // QK_K
        return (np.arange(k).reshape(ks, 8, QK)   # [super, pos8, pos32]
                .transpose(2, 1, 0).reshape(k))   # j = pos32, pos8, super
    kb = k // QK
    return (np.arange(k).reshape(kb, QK)          # [block, pos32]
            .transpose(1, 0).reshape(k))


@functools.cache
def _perm32(k: int) -> np.ndarray:
    """Per-32-block scale column order: perm32[r] = logical block index.
    Segment-local layouts store the segments' 128-block groups in segment
    order (scale column c*128 + beta holds segment c's local block beta)."""
    s = _n_segs(k)
    if s > 1:
        return np.concatenate(
            [_perm32(_SEG) + c * (_SEG // QK) for c in range(s)])
    if k % QK_K == 0:
        ks = k // QK_K
        return (np.arange(k // QK).reshape(ks, 8)  # [super, pos8]
                .transpose(1, 0).reshape(k // QK))
    return np.arange(k // QK)                      # 2-level: natural order


@functools.cache
def _inv_perm(k: int) -> np.ndarray:
    return np.argsort(_perm(k))


@functools.cache
def _block_cols(k: int) -> np.ndarray:
    """Stored scale column of each byte-lane i in [0, K/2) — the lanes i
    and i + K/2 share it. int32 [K/2]."""
    i = np.arange(k // 2)
    s = _n_segs(k)
    if s > 1:
        half = _SEG // 2
        return ((i // half) * 128 + i % 128).astype(np.int32)
    return (i % (k // QK)).astype(np.int32)


def _q6_seg(k: int) -> bool:
    """True when K uses the SEGMENT-LOCAL q6 lane order (K % 4096 == 0)."""
    return k % 4096 == 0


@functools.cache
def _perm_q6(k: int) -> np.ndarray:
    """q6_k device lane order (lane j -> logical element index).

    Global interleave (K %% 4096 != 0): 2-level (K/16, 16) -> (16, K/16)
    transpose, so lane j's scale block is ``j mod (K/16)``.
    Segment-local (K %% 4096 == 0, _q6_seg): byte-lane i carries block
    (i//1024)*128 + i%%128; within-block position = (i%%1024)//128 for
    the lo nibble, +8 for the hi nibble."""
    assert k % QK_K == 0, f"K={k} must be a multiple of {QK_K} for q6_k"
    if _q6_seg(k):
        kh = k // 2
        i = np.arange(kh)
        b = (i // 1024) * 128 + (i % 128)
        u = (i % 1024) // 128
        return np.concatenate([b * 16 + u, b * 16 + u + 8])
    kb = k // 16
    return (np.arange(k).reshape(kb, 16).transpose(1, 0).reshape(k))


@functools.cache
def _inv_perm_q6(k: int) -> np.ndarray:
    return np.argsort(_perm_q6(k))


def permute_activations_q6(x: jax.Array) -> jax.Array:
    """q6_k activation order (layout-aware gather by _perm_q6)."""
    k = x.shape[-1]
    return jnp.take(x, jnp.asarray(_perm_q6(k)), axis=-1)


def permute_activations(x: jax.Array) -> jax.Array:
    """Reorder x [..., K] into the interleaved column order (transposes
    only). Matches _perm, including the byte-split segment-local order for
    K % 4096 == 0, K > 4096."""
    *lead, k = x.shape
    nl = len(lead)
    s = _n_segs(k)
    if s > 1:
        # per-segment interleave (segment = 16 superblocks), then separate
        # the halves globally: [..., S, 2, 2048] -> [..., 2, S, 2048]
        return (x.reshape(*lead, s, 16, 8, QK)
                .transpose(*range(nl), nl, nl + 3, nl + 2, nl + 1)
                .reshape(*lead, s, 2, _SEG // 2)
                .transpose(*range(nl), nl + 1, nl, nl + 2)
                .reshape(*lead, k))
    if k % QK_K == 0:
        return (x.reshape(*lead, k // QK_K, 8, QK)
                .transpose(*range(nl), nl + 2, nl + 1, nl)
                .reshape(*lead, k))
    return (x.reshape(*lead, k // QK, QK)
            .transpose(*range(nl), nl + 1, nl)
            .reshape(*lead, k))


# ---------------------------------------------------------------------------
# device container
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantLinear:
    """Device-side quantized weight W [N, K] (output-major, like GGML),
    stored in the interleaved column order.

    fields per format (all column-permuted):
      q8_0: qs int8  [N, K],    d  f32  [N, K/32]
      q4_0: qs int8  [N, K/2],  d  f32  [N, K/32]          (q - 8 at dequant)
      q4_k: qs int8  [N, K/2],  es bf16 [N, K/32], em bf16 [N, K/32]
            ("Q4_K-E": effective scales/mins, see module docstring)
      q6_k: qs int8  [N, K/2] (low-4-bit halves, signed-friendly packed),
            qh int8  [N, K/4] (2-bit planes: byte i = lanes i, i+K/4,
            i+K/2, i+3K/4), es bf16 [N, K/16] ("Q6_K-E": d*sc effective
            per-16-block scales; 16-block lane order, see _perm_q6)
    """

    fmt: str = dataclasses.field(metadata=dict(static=True))
    # logical (pre-shard) shape; informational only — products derive their
    # dimensions from the arrays so shard_map-local shards work unchanged
    shape: tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    qs: jax.Array = None
    d: jax.Array = None
    es: jax.Array | None = None
    em: jax.Array | None = None
    qh: jax.Array | None = None
    # q4_k scale encoding: "e" (pre-expanded bf16 effective scales) or
    # "s6" (6-bit scales + bf16 superblock d — module docstring)
    enc: str = dataclasses.field(default="e", metadata=dict(static=True))

    @property
    def array_shape(self) -> tuple[int, int]:
        """[N, K] as implied by the (possibly shard-local) arrays."""
        n, kq = self.qs.shape
        return n, kq * (1 if self.fmt == "q8_0" else 2)

    @property
    def nbytes(self) -> int:
        return sum(f.size * f.dtype.itemsize
                   for f in (self.qs, self.d, self.es, self.em, self.qh)
                   if f is not None)


_FIELDS = {
    "q8_0": ("qs", "d"),
    "q4_0": ("qs", "d"),
    "q4_k": ("qs", "es", "em"),
    "q6_k": ("qs", "qh", "es"),
}
_FIELDS_S6 = ("qs", "es", "d")    # q4_k s6: es = sc|mn combined


def _fields(ql: "QuantLinear") -> tuple[str, ...]:
    if ql.fmt == "q4_k" and ql.enc == "s6":
        return _FIELDS_S6
    return _FIELDS[ql.fmt]


def _pack_halves(q_dev: np.ndarray) -> np.ndarray:
    """[N, K] nibble values (0..15) -> [N, K/2] int8: lane i | lane i+K/2.

    The high nibble is stored XOR 8 ("signed-friendly" packing): the int8
    value of the byte is then exactly ``lo + 16*hi - 128`` (the analog of
    the reference keeping V transposed-contiguous so its hot loop needs no
    layout fixups, flash_row_float.h:176-177: choose the storage encoding
    the kernel wants, once, at load time)."""
    k = q_dev.shape[-1]
    lo = q_dev[:, : k // 2].astype(np.uint8)
    hi = q_dev[:, k // 2:].astype(np.uint8)
    return (lo | ((hi ^ 8) << 4)).view(np.int8)


def q4_k_effective(t: quant_ref.Q4_K) -> tuple[np.ndarray, np.ndarray]:
    """The Q4_K-E contract: per-32-block effective scale/min in bf16,
    LOGICAL block order. Shared by from_oracle and the tests."""
    d8 = np.repeat(t.d, 8, axis=-1)          # [N, K/32] f32 (exact)
    dm8 = np.repeat(t.dmin, 8, axis=-1)
    es = (d8 * t.sc.astype(np.float32)).astype(ml_dtypes.bfloat16)
    em = (dm8 * t.mn.astype(np.float32)).astype(ml_dtypes.bfloat16)
    return es, em


def from_oracle(t, enc: str = "auto") -> QuantLinear:
    """Convert an oracle-quantized tensor (logical planar NumPy layout) to
    interleaved device arrays. ``enc`` (q4_k only): "auto" (= "e"), "s6",
    or "e" — see the module docstring."""
    n, k = t.shape
    p, p32 = _perm(k), _perm32(k)
    if isinstance(t, quant_ref.Q8_0):
        return QuantLinear(
            fmt="q8_0", shape=(n, k),
            qs=jnp.asarray(t.qs[:, p]),
            d=jnp.asarray(t.d[:, p32]))
    if isinstance(t, quant_ref.Q4_0):
        q = quant_ref.unpack_nibbles(
            t.qs.reshape(n, k // QK, QK // 2)).reshape(n, k)
        return QuantLinear(
            fmt="q4_0", shape=(n, k),
            qs=jnp.asarray(_pack_halves(q[:, p])),
            d=jnp.asarray(t.d[:, p32]))
    if isinstance(t, quant_ref.Q4_K):
        q = quant_ref.unpack_nibbles(
            t.qs.reshape(n, k // QK, QK // 2)).reshape(n, k)
        if enc == "auto" or (enc == "s6" and k % (128 * QK) != 0):
            enc = "e"                        # s6 needs kb % 128 == 0
        if enc == "s6":
            # raw 6-bit sc/mn one byte each, lane-concatenated (sc-half |
            # mn-half, scale column order), bf16 superblock d|dmin in
            # LOGICAL order
            sm = np.concatenate([t.sc[:, p32], t.mn[:, p32]],
                                axis=1).astype(np.int8)
            dd = np.concatenate([t.d, t.dmin], axis=1
                                ).astype(ml_dtypes.bfloat16)
            return QuantLinear(
                fmt="q4_k", shape=(n, k), enc="s6",
                qs=jnp.asarray(_pack_halves(q[:, p])),
                es=jnp.asarray(sm),
                d=jnp.asarray(dd))
        es, em = q4_k_effective(t)
        return QuantLinear(
            fmt="q4_k", shape=(n, k),
            qs=jnp.asarray(_pack_halves(q[:, p])),
            es=jnp.asarray(es[:, p32]),
            em=jnp.asarray(em[:, p32]))
    if isinstance(t, quant_ref.Q6_K):
        p6 = _perm_q6(k)
        v = t.qs[:, p6]                       # uint8 0..63, lane order
        lo4 = v & 0x0F
        hi2 = v >> 4                          # 2-bit high planes
        kq = k // 4
        # byte i packs the four planes of lanes (i, i+K/4, i+K/2, i+3K/4)
        # as TWO signed-friendly nibbles (h0+4*h1 | (h2+4*h3)^8 << 4)
        u_pairs = np.concatenate(
            [hi2[:, :kq] + 4 * hi2[:, kq:2 * kq],
             hi2[:, 2 * kq:3 * kq] + 4 * hi2[:, 3 * kq:]], axis=1)
        qh = _pack_halves(u_pairs)
        # effective per-16-block scale (signed: sc is int8); bf16 rounding
        # is ~0.4%, inside the 6-bit step (~1.6%) — same budget argument as
        # Q4_K-E. Scale-block lane order is natural under _perm_q6.
        es = (np.repeat(t.d, QK_K // 16, axis=-1)
              * t.sc.astype(np.float32)).astype(ml_dtypes.bfloat16)
        return QuantLinear(
            fmt="q6_k", shape=(n, k),
            qs=jnp.asarray(_pack_halves(lo4)),
            qh=jnp.asarray(qh),
            es=jnp.asarray(es))
    raise TypeError(f"unsupported oracle tensor {type(t)}")


def quantize(w: np.ndarray, fmt: str, enc: str = "auto") -> QuantLinear:
    """Quantize a float [N, K] weight into device arrays (native C++ codec,
    bit-identical to the oracle)."""
    from ggml_cuda_experiments_tpu.utils import native
    return from_oracle(native.quantize(np.asarray(w), fmt), enc)


def scales_to_e(ql: QuantLinear) -> QuantLinear:
    """Expand an s6-encoded q4_k weight to the "e" encoding (f32 effective
    scales = f32(bf16 d) * sc6, not re-rounded). Identity otherwise."""
    if not (ql.fmt == "q4_k" and ql.enc == "s6"):
        return ql
    n, k = ql.array_shape
    kb = k // QK
    s_tot = k // QK_K
    sb = jnp.asarray(np.asarray(_perm32(k)) // 8)            # [kb]
    d = jnp.take(ql.d[:, :s_tot], sb, axis=1).astype(jnp.float32)
    dm = jnp.take(ql.d[:, s_tot:], sb, axis=1).astype(jnp.float32)
    es = d * ql.es[:, :kb].astype(jnp.float32)
    em = dm * ql.es[:, kb:].astype(jnp.float32)
    return QuantLinear(fmt="q4_k", shape=ql.shape, enc="e",
                       qs=ql.qs, es=es, em=em)


# ---------------------------------------------------------------------------
# plain XLA path
# ---------------------------------------------------------------------------

def _dequant_lanes(ql: QuantLinear, dtype) -> jax.Array:
    """Dense [N, K] in DEVICE LANE order (no column gather of the weight)."""
    n, k = ql.array_shape
    if ql.fmt == "q6_k":
        p = ql.qs.astype(jnp.int32)                   # signed-friendly bytes
        lo = (p & 0xF).astype(jnp.float32)
        hi = (((p >> 4) & 0xF) ^ 8).astype(jnp.float32)
        nib = jnp.concatenate([lo, hi], axis=1)       # [N, K] lane order
        p2 = ql.qh.astype(jnp.int32)
        u_lo = (p2 & 0xF)                             # h0 + 4*h1
        u_hi = ((p2 >> 4) & 0xF) ^ 8                  # h2 + 4*h3
        h = jnp.concatenate(
            [u_lo & 3, u_lo >> 2, u_hi & 3, u_hi >> 2],
            axis=1).astype(jnp.float32)
        blk = jnp.asarray(np.asarray(_perm_q6(k)) // 16)
        es = ql.es.astype(jnp.float32)[:, blk]
        return (es * (nib + 16.0 * h - 32.0)).astype(dtype)
    ql = scales_to_e(ql)
    cols = jnp.asarray(_block_cols(k))
    if ql.fmt == "q8_0":
        s = ql.d.astype(jnp.float32)[:, cols]
        s = jnp.concatenate([s, s], axis=1)
        return (ql.qs.astype(jnp.float32) * s).astype(dtype)
    packed = ql.qs.astype(jnp.int32)                  # [N, K/2]
    lo = (packed & 0xF).astype(jnp.float32)
    hi = (((packed >> 4) & 0xF) ^ 8).astype(jnp.float32)
    if ql.fmt == "q4_0":
        s = ql.d.astype(jnp.float32)[:, cols]
        w = jnp.concatenate([(lo - 8.0) * s, (hi - 8.0) * s], axis=1)
    else:
        es = ql.es.astype(jnp.float32)[:, cols]
        em = ql.em.astype(jnp.float32)[:, cols]
        w = jnp.concatenate([lo * es - em, hi * es - em], axis=1)
    return w.astype(dtype)


def dequantize_jnp(ql: QuantLinear, dtype=jnp.float32) -> jax.Array:
    """XLA-only dequantization to a dense *logical-order* [N, K] array."""
    k = ql.array_shape[1]
    inv = _inv_perm_q6(k) if ql.fmt == "q6_k" else _inv_perm(k)
    return _dequant_lanes(ql, dtype)[:, jnp.asarray(inv)]


def _permute_x(x: jax.Array, fmt: str) -> jax.Array:
    return (permute_activations_q6(x) if fmt == "q6_k"
            else permute_activations(x))


def qmatmul_xla(x: jax.Array, ql: QuantLinear, compute_dtype=jnp.float32
                ) -> jax.Array:
    """Plain path: dequantize in lane order, reorder x to match, then one
    dot (cuBLAS on the card). f32 compute asks for full precision; the CPU
    backend computes in f32 (its dot has no bf16 x bf16 -> f32 form)."""
    if platform.backend() == "cpu":
        compute_dtype = jnp.float32
    w = _dequant_lanes(ql, compute_dtype)
    prec = (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    return jax.lax.dot_general(
        _permute_x(x, ql.fmt).astype(compute_dtype), w,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=prec,
    ).astype(x.dtype)


def fake_quant8(x: jax.Array) -> jax.Array:
    """Per-32-block int8 absmax quantize + dequantize of activations x
    [..., K] (llama.cpp's Q8 activation blocks); logical blocks map onto
    whole stored blocks, so this commutes with the column interleave."""
    *lead, k = x.shape
    xb = x.astype(jnp.float32).reshape(*lead, k // QK, QK)
    amax = jnp.max(jnp.abs(xb), axis=-1, keepdims=True)
    scale = jnp.where(amax == 0.0, 1.0, amax / 127.0)
    q = jnp.clip(jnp.round(xb / scale), -127, 127)
    return (q * scale).reshape(*lead, k)


# ---------------------------------------------------------------------------
# fused dequant-matvec kernel (Pallas through Triton)
# ---------------------------------------------------------------------------

def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two <= cap dividing n."""
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


# Byte-lanes of one row in the kernel's view: [S, R, kbl], where lane
# i = (s*R + t)*kbl + c has scale column s*kbl + c. R = 16 for every layout
# (K/2 byte-lanes over K/32 scale columns); S > 1 only for the segment-local
# order (kbl = 128 per 4096-element segment).
_R = 16


def _lane_view(k: int) -> tuple[int, int]:
    """(S, kbl) of the [S, 16, kbl] byte-lane view of a K-wide row."""
    s = _n_segs(k)
    return s, k // QK // s


def kernel_plan(n: int, k: int, rows: int, block_n: int | None = None,
                k_splits: int | None = None) -> dict:
    """Tile plan of the kernel for an [N, K] weight and ``rows`` rows of x:
    ``bn`` weight rows per block; ``cc`` scale columns per loop step (a
    step covers ``bc`` = 16 * cc byte-lanes, all sharing those cc scale
    columns); ``k_splits`` blocks along K, each taking ``chunks_per_split``
    steps (the last may take fewer; partial sums are added in XLA); ``bp``
    padded x rows. ``ok`` is False when the shape has no tiling."""
    kh = k // 2
    segs, kbl = _lane_view(k)
    # one row of x runs on the CUDA cores (no padding); more rows pad to
    # the 16-row tensor-core tile
    bp = 1 if rows == 1 else max(16, 1 << (rows - 1).bit_length())
    tile_n, tile_c = TILE_ROW if bp == 1 else TILE_MMA
    cc = _pow2_divisor(kbl, tile_c)
    bc = _R * cc
    bn = block_n or _pow2_divisor(n, tile_n)
    chunks = kh // bc
    if k_splits is None:
        k_splits = 1
        while (n // max(bn, 1) * k_splits < TARGET_BLOCKS
               and chunks >= 4 * k_splits):
            k_splits *= 2
    ok = (bn >= 16 and n % bn == 0 and bp <= KERNEL_MAX_ROWS and bc >= 16
          and k_splits <= chunks)
    return dict(bn=bn, cc=cc, bc=bc, k_splits=k_splits, bp=bp, ok=ok,
                chunks=chunks, chunks_per_split=-(-chunks // k_splits))


# (weight rows per block, scale columns per step), from sweeps on the card
# at the 7B shapes (PERF.md): for one row of x, and for tensor-core tiles.
TILE_ROW = (32, 32)
TILE_MMA = (64, 16)
TARGET_BLOCKS = 256          # about two blocks per SM on a 132-SM card
NUM_WARPS = 4
NUM_STAGES = 3


def _qmv_kernel(x_ref, qs_ref, s1_ref, s2_ref, o_ref, *, fmt: str,
                segs: int, kbl: int, cc: int, chunks: int, per_split: int,
                compute_dtype):
    """One [bn, bp] output tile over one K split.

    x: [2S, 16, kbl, bp] permuted activations (lo half, then hi half);
    qs: [bn, S, 16, kbl] packed q4 bytes, or [bn, 2S, 16, kbl] q8_0 values;
    s1 / s2: [bn, S, kbl] scales (d, or es / em for q4_k). Each step takes
    cc scale columns and the 16 x cc byte-lanes that share them, so a
    scale is loaded once and broadcast in registers."""
    bn = qs_ref.shape[0]
    per_seg = kbl // cc
    j0 = pl.program_id(1) * per_split
    prec = (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)

    def body(j, acc):
        s = j // per_seg
        cols = pl.ds((j % per_seg) * cc, cc)
        sc = s1_ref[:, s, cols].astype(jnp.float32)[:, None, :]
        if fmt == "q8_0":
            w_lo = qs_ref[:, s, :, cols].astype(jnp.float32) * sc
            w_hi = qs_ref[:, segs + s, :, cols].astype(jnp.float32) * sc
        else:
            p = qs_ref[:, s, :, cols].astype(jnp.int32)
            lo = (p & 0xF).astype(jnp.float32)
            hi = (((p >> 4) & 0xF) ^ 8).astype(jnp.float32)
            if fmt == "q4_0":
                w_lo, w_hi = (lo - 8.0) * sc, (hi - 8.0) * sc
            else:
                m = s2_ref[:, s, cols].astype(jnp.float32)[:, None, :]
                w_lo, w_hi = lo * sc - m, hi * sc - m
        w_lo = w_lo.reshape(bn, _R * cc)
        w_hi = w_hi.reshape(bn, _R * cc)
        if acc.shape[1] == 1:          # one row: multiply-add, no MMA tile
            xl = x_ref[s, :, cols, :].reshape(1, _R * cc)
            xh = x_ref[segs + s, :, cols, :].reshape(1, _R * cc)
            acc += jnp.sum(w_lo * xl.astype(jnp.float32)
                           + w_hi * xh.astype(jnp.float32), axis=1)[:, None]
            return acc
        xl = x_ref[s, :, cols, :].reshape(_R * cc, -1)
        xh = x_ref[segs + s, :, cols, :].reshape(_R * cc, -1)
        acc += pl.dot(w_lo.astype(compute_dtype), xl, precision=prec)
        acc += pl.dot(w_hi.astype(compute_dtype), xh, precision=prec)
        return acc

    acc = jax.lax.fori_loop(j0, jnp.minimum(j0 + per_split, chunks), body,
                            jnp.zeros(o_ref.shape, jnp.float32))
    o_ref[...] = acc


def _qmatvec_kernel(x: jax.Array, ql: QuantLinear, plan: dict,
                    compute_dtype) -> jax.Array:
    """x [B, K] logical order -> [B, N] f32 through _qmv_kernel."""
    n, k = ql.array_shape
    b = x.shape[0]
    bn, ks, bp = plan["bn"], plan["k_splits"], plan["bp"]
    segs, kbl = _lane_view(k)
    halves = 2 if ql.fmt == "q8_0" else 1
    # one row stays f32 (CUDA-core multiply-add); tiles feed the MMA in
    # compute_dtype
    x_dtype = jnp.float32 if bp == 1 else compute_dtype
    x4 = (jnp.pad(permute_activations(x.astype(jnp.float32)),
                  ((0, bp - b), (0, 0))).T.astype(x_dtype)
          .reshape(2 * segs, _R, kbl, bp))
    qs = ql.qs.reshape(n, halves * segs, _R, kbl)
    if ql.fmt == "q4_k":
        s1, s2 = ql.es, ql.em
    else:
        s1 = s2 = ql.d
    s1, s2 = s1.reshape(n, segs, kbl), s2.reshape(n, segs, kbl)
    out = pl.pallas_call(
        functools.partial(_qmv_kernel, fmt=ql.fmt, segs=segs, kbl=kbl,
                          cc=plan["cc"], chunks=plan["chunks"],
                          per_split=plan["chunks_per_split"],
                          compute_dtype=compute_dtype),
        out_shape=jax.ShapeDtypeStruct((ks, n, bp), jnp.float32),
        grid=(n // bn, ks),
        in_specs=[
            pl.BlockSpec(x4.shape, lambda i, j: (0, 0, 0, 0)),
            pl.BlockSpec((bn, halves * segs, _R, kbl),
                         lambda i, j: (i, 0, 0, 0)),
            pl.BlockSpec((bn, segs, kbl), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((bn, segs, kbl), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, bn, bp), lambda i, j: (j, i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=platform.interpret(),
        name=f"qmatvec_{ql.fmt}",
    )(x4, qs, s1, s2)
    return out.sum(axis=0)[:, :b].T


def choose_impl(ql: QuantLinear, rows: int, impl: str | None = None,
                block_n: int | None = None) -> str:
    """The op choice: the kernel for kernel formats at up to
    KERNEL_MAX_ROWS rows on the card (or when asked for), XLA otherwise.
    Asking for the kernel on a shape it cannot tile is an error."""
    n, k = ql.array_shape
    fits = (ql.fmt in KERNEL_FMTS
            and kernel_plan(n, k, rows, block_n)["ok"])
    default = GPU_IMPL if (fits and rows <= KERNEL_MAX_ROWS) else "xla"
    impl = platform.resolve_impl(impl, default, ("kernel", "xla"))
    if impl == "kernel" and not fits:
        raise ValueError(f"no kernel tiling for {ql.fmt} [{n}, {k}] at "
                         f"{rows} rows")
    return impl


@functools.partial(
    jax.jit,
    static_argnames=("compute_dtype", "out_dtype", "x_quant8", "impl",
                     "block_n", "k_splits"),
)
def qmatmul(
    x: jax.Array,
    ql: QuantLinear,
    *,
    compute_dtype=jnp.bfloat16,
    out_dtype=None,
    x_quant8: bool = False,
    impl: str | None = None,
    block_n: int | None = None,
    k_splits: int | None = None,
) -> jax.Array:
    """y[B, N] = x[B, K] @ dequant(W[N, K])^T; x in logical order.

    ``impl``: "kernel" (the fused Triton matvec), "xla" (dequantize + dot)
    or None (``choose_impl``). ``x_quant8``: fake-quantize x per 32-block
    to int8 first (llama.cpp's Q4_K x Q8 decode numerics) on every path.
    """
    n, k = ql.array_shape
    b = x.shape[0]
    assert x.shape[1] == k, f"x K={x.shape[1]} vs weight K={k}"
    out_dtype = out_dtype or x.dtype
    if x_quant8:
        x = fake_quant8(x)
    impl = choose_impl(ql, b, impl, block_n)
    if impl == "xla":
        return qmatmul_xla(x, ql, compute_dtype).astype(out_dtype)
    plan = kernel_plan(n, k, b, block_n, k_splits)
    assert plan["ok"], plan
    y = _qmatvec_kernel(x, scales_to_e(ql), plan, compute_dtype)
    return y.astype(out_dtype)
