"""Prefill attention (ops/attention.py) vs the attention oracle — the analog
of the reference's kernel_test / test_llama comparisons (kernel_test.h
shapes: head_dim=128, GQA 32/8 heads) with hard tolerance asserts. The CPU
runs the plain path; cuDNN's is checked on the card (tests/test_on_card.py,
run by chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ggml_cuda_experiments_tpu.ops.attention import attention, choose_impl
from ggml_cuda_experiments_tpu.oracle.attention import attention_ref
from ggml_cuda_experiments_tpu.utils.harness import assert_close


def _rand_qkv(rng, b, hq, hkv, sq, sk, d, dtype=np.float32):
    q = rng.normal(size=(b, hq, sq, d)).astype(dtype)
    k = rng.normal(size=(b, hkv, sk, d)).astype(dtype)
    v = rng.normal(size=(b, hkv, sk, d)).astype(dtype)
    return q, k, v


def test_basic(rng):
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 256, 64)
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = attention_ref(q, k, v)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="flash basic")


def test_gqa_kernel_test_shapes(rng):
    """The reference harness config: 32 q heads, 8 kv heads, head_dim 128,
    kv 512 (kernel_test.h:2,25-27) — batch=1 decode-style plus longer q."""
    q, k, v = _rand_qkv(rng, 1, 32, 8, 128, 512, 128)
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = attention_ref(q, k, v)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="flash GQA 32/8")


def test_causal(rng):
    q, k, v = _rand_qkv(rng, 2, 4, 4, 256, 256, 64)
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
    want = attention_ref(q, k, v, causal=True)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="flash causal")


def test_causal_offset(rng):
    """Sq < Sk: queries are the last Sq positions (decode/chunked prefill)."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 512, 64)
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
    want = attention_ref(q, k, v, causal=True)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="flash causal offset")


def test_additive_mask(rng):
    """Explicit additive mask, incl. a fully-masked run of KV positions
    (flash-llama.h:276-278 analog)."""
    b, hq, hkv, sq, sk, d = 1, 4, 2, 128, 512, 64
    q, k, v = _rand_qkv(rng, b, hq, hkv, sq, sk, d)
    mask = np.zeros((1, 1, sq, sk), np.float32)
    mask[..., 256:384] = -np.inf      # one whole 128-block masked out
    mask[..., ::7] = -np.inf          # scattered masking
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask))
    want = attention_ref(q, k, v, mask=mask)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="flash mask")


def test_scale(rng):
    q, k, v = _rand_qkv(rng, 1, 2, 1, 128, 128, 64)
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=0.25)
    want = attention_ref(q, k, v, scale=0.25)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="flash scale")


def test_residuals_enable_cross_shard_merge(rng):
    """Splitting KV across two kernel calls and merging with the lse ops must
    equal one full-KV call — the context-parallel contract."""
    from ggml_cuda_experiments_tpu.ops.lse import AttnPartial, lse_combine, lse_finalize
    b, h, sq, sk, d = 1, 2, 128, 512, 64
    q, k, v = _rand_qkv(rng, b, h, h, sq, sk, d)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want = np.asarray(attention(qj, kj, vj))

    half = sk // 2
    parts = []
    for sl in (slice(0, half), slice(half, sk)):
        o, lse = attention(qj, kj[:, :, sl], vj[:, :, sl],
                                 return_residuals=True)
        # convert (o_normalized, lse) into an (o_unnorm, m, s) partial with
        # m := lse, s := 1 (valid: o_unnorm = o * exp(lse - m) * s)
        parts.append(AttnPartial(
            o.astype(jnp.float32),
            lse[..., None],
            jnp.ones((*lse.shape, 1), jnp.float32),
        ))
    merged = lse_finalize(lse_combine(*parts))
    assert_close(merged, want, atol=2e-3, rtol=2e-3, name="residual merge")


def test_bf16(rng):
    q, k, v = _rand_qkv(rng, 1, 4, 4, 128, 256, 64)
    got = attention(jnp.asarray(q, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16))
    want = attention_ref(q, k, v, operand_dtype=jnp.bfloat16)
    assert_close(got, want, atol=3e-2, rtol=3e-2, name="flash bf16")


def test_kv_lengths_match_mask(rng):
    """kv_lengths (the engine's padded-prompt mask) == the additive mask."""
    q, k, v = _rand_qkv(rng, 2, 4, 2, 64, 64, 32)
    lens = np.array([17, 64], np.int32)
    mask = np.where(np.arange(64)[None, None, None, :]
                    < lens[:, None, None, None], 0.0, -np.inf)
    got = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, kv_lengths=jnp.asarray(lens))
    want = attention_ref(q, k, v, mask=mask.astype(np.float32), causal=True)
    assert_close(got, want, atol=2e-3, rtol=2e-3, name="kv_lengths")


def test_fully_masked_rows_are_zero(rng):
    """A query row with no visible key gives 0 (and lse -inf), not NaN."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 16, 16, 16)
    mask = np.zeros((1, 1, 16, 16), np.float32)
    mask[..., 3, :] = -np.inf
    o, lse = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), return_residuals=True)
    assert np.all(np.asarray(o)[:, :, 3] == 0)
    assert np.all(np.isneginf(np.asarray(lse)[:, :, 3]))
    assert np.isfinite(np.asarray(o)).all()


@pytest.mark.parametrize("case,want", [
    (dict(dtype=jnp.bfloat16), "cudnn"),
    (dict(dtype=jnp.float32), "xla"),                  # cuDNN: 16-bit only
    (dict(dtype=jnp.bfloat16, mask=True), "xla"),      # arbitrary mask
    (dict(dtype=jnp.bfloat16, causal=True, sk=256), "xla"),  # Sq != Sk
    (dict(dtype=jnp.bfloat16, causal=True), "cudnn"),
    (dict(dtype=jnp.bfloat16, residuals=True), "xla"),
])
def test_choose_impl_on_card(monkeypatch, case, want):
    """The card's choice is decided by dtype and options, never by
    try/except; the CPU always runs the plain path."""
    from ggml_cuda_experiments_tpu.utils import platform
    q = jnp.zeros((1, 4, 128, 64), case["dtype"])
    k = jnp.zeros((1, 2, case.get("sk", 128), 64), case["dtype"])
    mask = jnp.zeros((1, 1, 128, k.shape[2])) if case.get("mask") else None
    args = (q, k, mask, case.get("causal", False), case.get("residuals",
                                                           False))
    assert choose_impl(*args) == "xla"                 # this is the CPU
    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    assert choose_impl(*args) == want
    if want == "xla":
        with pytest.raises(ValueError):
            choose_impl(*args, impl="cudnn")
