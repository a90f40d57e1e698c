"""Llama-family model: functional forward pass + KV-cached decode engine.

The end-to-end slice of SURVEY §7: quantized linears (fused dequant matvec),
RoPE, RMSNorm, fused-attention prefill, split-KV flash decode — everything
jit-compiled, static shapes, cache donated across steps. The reference has no
model layer (it tests kernels against llama.cpp *dumps*,
/root/reference/src/flash-matrix.cu:69-73); this module is what turns the
kernel engine into an inference engine (BASELINE.json configs 2-5).

Weights are a pytree dict whose linear leaves are either dense ``jax.Array``
[N, K] (output-major) or ``QuantLinear`` (Q8_0/Q4_0/Q4_K); dispatch happens
per-call, so mixed-precision models (quantized matmuls, bf16 norms/embed)
are just trees.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.ops.attention import attention
from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu.ops.quant_matmul import (
    QuantLinear, qmatmul, quantize,
)

Params = dict[str, Any]


def apply_linear(x: jax.Array, w, xq8: bool = False,
                 impl: str | None = None) -> jax.Array:
    """y = x @ W^T for dense [N, K] or QuantLinear weights; x: [..., K].
    Quantized weights go through ``qmatmul``, which picks the fused decode
    kernel or XLA's dequantize + dot by row count (quant_matmul.choose_impl)
    unless ``impl`` says which."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QuantLinear):
        y = qmatmul(x2, w, x_quant8=xq8, impl=impl)
    else:
        y = jax.lax.dot_general(
            x2.astype(w.dtype), w,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(x.dtype)
    return y.reshape(*lead, -1)


def qkv_proj(layer: Params, x: jax.Array, cfg: ModelConfig):
    """Query/key/value projections; uses the fused wqkv weight when present
    (one weight stream + one kernel launch instead of three)."""
    if "wqkv" in layer:
        y = apply_linear(x, layer["wqkv"], cfg.x_quant8, cfg.impl)
        s1 = cfg.n_heads * cfg.head_dim
        s2 = s1 + cfg.n_kv_heads * cfg.head_dim
        return y[..., :s1], y[..., s1:s2], y[..., s2:]
    return (apply_linear(x, layer["wq"], cfg.x_quant8, cfg.impl),
            apply_linear(x, layer["wk"], cfg.x_quant8, cfg.impl),
            apply_linear(x, layer["wv"], cfg.x_quant8, cfg.impl))


def gate_up_proj(layer: Params, x: jax.Array, xq8: bool = False,
                 impl: str | None = None):
    """Gate/up projections; fused w_gu when present."""
    if "w_gu" in layer:
        y = apply_linear(x, layer["w_gu"], xq8, impl)
        h = y.shape[-1] // 2
        return y[..., :h], y[..., h:]
    return (apply_linear(x, layer["w_gate"], xq8, impl),
            apply_linear(x, layer["w_up"], xq8, impl))


def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w


def rope(x: jax.Array, positions: jax.Array, theta: float) -> jax.Array:
    """Rotary embedding, rotate-half (HF Llama) convention.

    x: [B, T, H, D]; positions: [B, T] int32.
    """
    d = x.shape[-1]
    freqs = theta ** (-jnp.arange(0, d // 2, dtype=jnp.float32) / (d // 2))
    ang = positions.astype(jnp.float32)[..., None] * freqs     # [B, T, D/2]
    cos = jnp.cos(ang)[:, :, None, :]
    sin = jnp.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    xf1, xf2 = x1.astype(jnp.float32), x2.astype(jnp.float32)
    return jnp.concatenate(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], axis=-1
    ).astype(x.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """Contiguous per-layer KV cache (paged variant in ops/paged_attention).

    k, v: [n_layers, B, Hkv, S, D] (bf16; int8 or f8_e4m3 when quantized);
    k_scale, v_scale: [n_layers, B, Hkv, S] f32 per-token dequant scales
    (None for the unquantized cache); lengths: [B] valid prefix length.
    """
    k: jax.Array
    v: jax.Array
    lengths: jax.Array
    k_scale: jax.Array | None = None
    v_scale: jax.Array | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def quant_fmt(self) -> str | None:
        if not self.quantized:
            return None
        return "int8" if self.k.dtype == jnp.int8 else "fp8"

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int,
               dtype=jnp.bfloat16, quantized: bool | str = False
               ) -> "KVCache":
        """``quantized``: False, True/"int8", or "fp8" (float8_e4m3 payload
        with the same per-token f32 scales — BASELINE's INT8/FP8 KV)."""
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        if quantized:
            qdt = jnp.float8_e4m3fn if quantized == "fp8" else jnp.int8
            return KVCache(
                k=jnp.zeros(shape, qdt),
                v=jnp.zeros(shape, qdt),
                lengths=jnp.zeros((batch,), jnp.int32),
                k_scale=jnp.zeros(shape[:-1], jnp.float32),
                v_scale=jnp.zeros(shape[:-1], jnp.float32),
            )
        return KVCache(
            k=jnp.zeros(shape, dtype),
            v=jnp.zeros(shape, dtype),
            lengths=jnp.zeros((batch,), jnp.int32),
        )


def _write_cache_layer(cache: jax.Array, li, new: jax.Array,
                       pos: jax.Array, b0=0, valid=None) -> jax.Array:
    """Insert new [B, Hkv, T, ...] into the FULL cache [L, B, Hkv, S, ...]
    at (li, b0 + b, :, pos[b]) — per-(layer, sequence) dynamic-update-slices
    are tiny and alias in place under donation (a per-layer slice/stack
    rebuild would copy the entire cache every decode step).

    ``b0``: batch-row offset (traced ok; pipeline microbatches).
    ``valid``: optional scalar bool — when False the write is a no-op
    (blends the existing value back in; pipeline bubble steps)."""
    B = new.shape[0]
    for b in range(B):
        idx = (li, b0 + b, 0, pos[b]) + (0,) * (new.ndim - 3)
        val = new[b][None, None].astype(cache.dtype)
        if valid is not None:
            old = jax.lax.dynamic_slice(cache, idx, val.shape)
            val = jnp.where(valid, val, old)
        cache = jax.lax.dynamic_update_slice(cache, val, idx)
    return cache


def _quantize_rowwise(x: jax.Array, fmt: str = "int8"
                      ) -> tuple[jax.Array, jax.Array]:
    """Per-token absmax quantization of [..., D] to int8 or float8_e4m3
    (jnp analog of the oracle's quantize_{int8,fp8}_rowwise)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    if fmt == "fp8":
        scale = amax / 448.0
        q = (xf / jnp.where(scale == 0.0, 1.0, scale)
             ).astype(jnp.float8_e4m3fn)
    else:
        scale = amax / 127.0
        q = jnp.clip(jnp.round(xf / jnp.where(scale == 0.0, 1.0, scale)),
                     -127, 127).astype(jnp.int8)
    return q, scale[..., 0]


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------

def _attention_block(layer: Params, cfg: ModelConfig, h: jax.Array,
                     cache: "KVCache", li, positions, *, decode: bool,
                     reduce_axis: str | None = None, b0=0, valid=None):
    """Shared attention block; returns (attn_out, updated cache).

    ``reduce_axis``: shard_map axis name for tensor parallelism — cfg then
    describes the *local* shard (n_heads/n_kv_heads divided), wq/wk/wv are
    column-parallel, and the wo row-parallel product is psum-reduced.
    ``b0``/``valid``: pipeline microbatching — h covers cache batch rows
    [b0, b0+B), and writes are suppressed on bubble steps (valid=False).
    """
    B, T, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    quantized = cache.quantized
    micro = not (isinstance(b0, int) and b0 == 0 and valid is None)
    if micro:
        lengths = jax.lax.dynamic_slice_in_dim(cache.lengths, b0, B)
    else:
        lengths = cache.lengths

    x = rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    q, k, v = qkv_proj(layer, x, cfg)
    q = q.reshape(B, T, Hq, D)
    k = k.reshape(B, T, Hkv, D)
    v = v.reshape(B, T, Hkv, D)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kt = k.transpose(0, 2, 1, 3)        # [B, Hkv, T, D]
    vt = v.transpose(0, 2, 1, 3)
    pos0 = positions[:, 0]
    if quantized:
        kq, ksc = _quantize_rowwise(kt, cache.quant_fmt)
        vq, vsc = _quantize_rowwise(vt, cache.quant_fmt)
        cache = KVCache(
            k=_write_cache_layer(cache.k, li, kq, pos0, b0, valid),
            v=_write_cache_layer(cache.v, li, vq, pos0, b0, valid),
            lengths=cache.lengths,
            k_scale=_write_cache_layer(cache.k_scale, li, ksc, pos0, b0,
                                       valid),
            v_scale=_write_cache_layer(cache.v_scale, li, vsc, pos0, b0,
                                       valid),
        )
    else:
        cache = KVCache(
            k=_write_cache_layer(cache.k, li, kt, pos0, b0, valid),
            v=_write_cache_layer(cache.v, li, vt, pos0, b0, valid),
            lengths=cache.lengths, k_scale=None, v_scale=None,
        )

    if decode:
        if not micro:
            # full stacked cache into the kernel, which offsets to the
            # layer itself: an XLA slice (cache.k[li]) feeding the custom
            # call would copy the whole layer (~16 MB at 7B, S=2048)
            o = flash_decode(
                q[:, 0],                   # [B, Hq, D]
                cache.k, cache.v, lengths + 1, layer=li,
                k_scale=cache.k_scale, v_scale=cache.v_scale, impl=cfg.impl,
            )[:, None]                     # [B, 1, Hq, D]
        else:
            def layer_rows(arr):
                """This layer's rows [B, Hkv, S, ...] for batch b0:b0+B."""
                sizes = (1, B) + arr.shape[2:]
                idx = (li, b0) + (0,) * (arr.ndim - 2)
                return jax.lax.dynamic_slice(arr, idx, sizes)[0]

            o = flash_decode(
                q[:, 0],                   # [B, Hq, D]
                layer_rows(cache.k), layer_rows(cache.v), lengths + 1,
                k_scale=None if not quantized else layer_rows(cache.k_scale),
                v_scale=None if not quantized else layer_rows(cache.v_scale),
                impl=cfg.impl,
            )[:, None]                     # [B, 1, Hq, D]
    else:
        # prefill attends over the fresh bf16 K/V (the cache, possibly
        # int8, starts empty for prefill — chunked prefill over an existing
        # quantized prefix is the paged pipeline's job)
        o = attention(
            q.transpose(0, 2, 1, 3), kt, vt, causal=True,
            impl=None if cfg.impl is None else "xla",
        ).transpose(0, 2, 1, 3)            # [B, T, Hq, D]

    o = o.reshape(B, T, Hq * D).astype(h.dtype)
    out = apply_linear(o, layer["wo"], cfg.x_quant8, cfg.impl)
    if reduce_axis is not None:
        out = jax.lax.psum(out, reduce_axis)
    return out, cache


def _mlp_block(layer: Params, cfg: ModelConfig, h: jax.Array,
               reduce_axis: str | None = None,
               expert_axis: str | None = None) -> jax.Array:
    x = rms_norm(h, layer["mlp_norm"], cfg.rms_eps)
    if "router" in layer:                   # mixture-of-experts MLP
        from ggml_cuda_experiments_tpu.models import moe
        out = moe.moe_mlp(layer, cfg, x, expert_axis=expert_axis,
                          xq8=cfg.x_quant8)
        if reduce_axis is not None and expert_axis != reduce_axis:
            # experts replicated over the tp axis contribute identical
            # partials only when inter is tp-sharded; dense experts here
            # are expert-sharded only, so nothing to reduce on ``model``.
            pass
        return out
    gate, up = gate_up_proj(layer, x, cfg.x_quant8, cfg.impl)
    out = apply_linear(
        jax.nn.silu(gate.astype(jnp.float32)).astype(x.dtype) * up,
        layer["w_down"], cfg.x_quant8, cfg.impl)
    if reduce_axis is not None:
        out = jax.lax.psum(out, reduce_axis)
    return out


def _forward(params: Params, cfg: ModelConfig, tokens: jax.Array,
             cache: KVCache, positions: jax.Array, *, decode: bool,
             reduce_axis: str | None = None,
             expert_axis: str | None = None,
             all_logits: bool = False) -> tuple[jax.Array, KVCache]:
    h = params["embed"][tokens]            # [B, T, dim]
    for li, layer in enumerate(params["layers"]):
        attn, cache = _attention_block(
            layer, cfg, h, cache, li, positions, decode=decode,
            reduce_axis=reduce_axis)
        h = h + attn
        h = h + _mlp_block(layer, cfg, h, reduce_axis=reduce_axis,
                           expert_axis=expert_axis)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return _head_logits(params, cfg, h, cache, tokens, all_logits)


def _head_logits(params: Params, cfg: ModelConfig, h: jax.Array,
                 cache: KVCache, tokens: jax.Array, all_logits: bool
                 ) -> tuple[jax.Array, KVCache]:
    """Final-norm output ``h`` -> logits; bumps cache lengths."""
    hl = h if all_logits else h[:, -1]
    logits = apply_linear(hl, params["lm_head"], cfg.x_quant8, cfg.impl)
    cache = dataclasses.replace(
        cache, lengths=cache.lengths + tokens.shape[1])
    return logits.astype(jnp.float32), cache


@functools.partial(jax.jit, static_argnames=("cfg", "all_logits"))
def prefill(params: Params, cfg: ModelConfig, tokens: jax.Array,
            cache: KVCache, all_logits: bool = False
            ) -> tuple[jax.Array, KVCache]:
    """Process a prompt [B, T] (T padded to the flash block size by caller);
    returns last-position logits ([B, T, V] when ``all_logits``, for
    perplexity evaluation) and the filled cache."""
    B, T = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    return _forward(params, cfg, tokens, cache, positions, decode=False,
                    all_logits=all_logits)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("cache",))
def decode_step(params: Params, cfg: ModelConfig, tokens: jax.Array,
                cache: KVCache) -> tuple[jax.Array, KVCache]:
    """One decode step: tokens [B] -> logits [B, vocab]; cache donated."""
    positions = cache.lengths[:, None]
    return _forward(params, cfg, tokens[:, None], cache, positions,
                    decode=True)


def generate(params: Params, cfg: ModelConfig, prompt: jax.Array,
             steps: int, cache: KVCache | None = None,
             sampling=None, seed: int = 0) -> np.ndarray:
    """Generation via a host loop over a jitted, cache-donating step.
    Greedy by default; pass a ``sampling.SamplingParams`` for
    temperature / top-k / top-p."""
    from ggml_cuda_experiments_tpu.models.sampling import sample

    B, T = prompt.shape
    if cache is None:
        max_len = _round_up(T + steps, 256)
        cache = KVCache.create(cfg, B, max_len)
    key = jax.random.PRNGKey(seed)

    def pick(logits, i):
        if sampling is None:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return sample(logits, jax.random.fold_in(key, i), sampling)

    logits, cache = prefill(params, cfg, prompt, cache)
    out = []
    tok = pick(logits, 0)
    for i in range(steps):
        out.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = pick(logits, i + 1)
    return np.stack([np.asarray(t) for t in out], axis=1)


@functools.partial(jax.jit, static_argnames=("cfg", "steps"))
def generate_scan(params: Params, cfg: ModelConfig, prompt: jax.Array,
                  cache: KVCache, steps: int) -> jax.Array:
    """Fully-jitted greedy generation via lax.scan (benchmark path)."""
    logits, cache = prefill(params, cfg, prompt, cache)
    tok0 = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    def body(carry, _):
        tok, cache = carry
        logits, cache = decode_step(params, cfg, tok, cache)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return (nxt, cache), tok

    (_, _), toks = jax.lax.scan(body, (tok0, cache), None, length=steps)
    return toks.T                           # [B, steps]


# ---------------------------------------------------------------------------
# weight creation / quantization
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pool_map(fn, items: list) -> list:
    """``[fn(i) for i in items]`` on a thread pool: NumPy's generators and
    array copies release the GIL, so per-layer host work runs in parallel."""
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def init_weights(cfg: ModelConfig, seed: int = 0, dtype=jnp.bfloat16,
                 as_numpy: bool = False) -> Params:
    """Random-init weights (scaled normal), dense. Use ``quantize_params``
    or the weight loader (utils/loader.py) for quantized models.

    Every tensor draws from its own stream, keyed by (seed, layer, tensor),
    so the layers are generated in parallel. ``as_numpy`` keeps leaves as
    host ml_dtypes arrays — essential for big models that will be quantized
    host-side before transfer (avoids a device round trip per tensor)."""
    import ml_dtypes
    d, hd = cfg.dim, cfg.head_dim
    np_dtype = {jnp.bfloat16: ml_dtypes.bfloat16,
                jnp.float32: np.float32}.get(dtype, np.float32)
    conv = (lambda a: a.astype(np_dtype)) if as_numpy else (
        lambda a: jnp.asarray(a, dtype))

    def normal(key, shape, scale):
        rng = np.random.default_rng([seed, *key])
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(scale)
        return conv(x)

    def lin(key, n, k):
        return normal(key, (n, k), 1.0 / np.sqrt(k))

    ones = lambda: conv(np.ones((d,), np.float32))
    shapes = {"wq": (cfg.n_heads * hd, d), "wk": (cfg.n_kv_heads * hd, d),
              "wv": (cfg.n_kv_heads * hd, d), "wo": (d, cfg.n_heads * hd),
              "w_gate": (cfg.intermediate, d), "w_up": (cfg.intermediate, d),
              "w_down": (d, cfg.intermediate)}

    def layer(i):
        out = {name: lin((i, j), *shape)
               for j, (name, shape) in enumerate(shapes.items())}
        return {**out, "attn_norm": ones(), "mlp_norm": ones()}

    return {
        "embed": normal((cfg.n_layers, 0), (cfg.vocab_size, d), 0.02),
        "layers": _pool_map(layer, list(range(cfg.n_layers))),
        "final_norm": ones(),
        "lm_head": lin((cfg.n_layers, 1), cfg.vocab_size, d),
    }


_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_params(params: Params, fmt: str, *, quantize_head: bool = True,
                    fuse: bool = True,
                    head_fmt: str | None = None) -> Params:
    """Quantize every big linear to ``fmt`` (embed/norms stay dense).

    ``fuse``: concatenate wq|wk|wv into ``wqkv`` and w_gate|w_up into
    ``w_gu`` — one weight stream and one kernel launch per projection.
    ``head_fmt``: optional different format for the lm_head (llama.cpp's
    Q4_K_M mix stores output.weight as Q6_K: fmt="q4_k",
    head_fmt="q6_k").
    """
    out = dict(params)

    def quantize_layer(layer):
        ql = dict(layer)

        def get(key):
            return np.asarray(layer[key], np.float32)

        if fuse:
            for key in ("wq", "wk", "wv", "w_gate", "w_up"):
                ql.pop(key)
            ql["wqkv"] = quantize(
                np.concatenate([get("wq"), get("wk"), get("wv")]), fmt)
            ql["w_gu"] = quantize(
                np.concatenate([get("w_gate"), get("w_up")]), fmt)
            ql["wo"] = quantize(get("wo"), fmt)
            ql["w_down"] = quantize(get("w_down"), fmt)
        else:
            for key in _LINEAR_KEYS:
                ql[key] = quantize(get(key), fmt)
        return ql

    out["layers"] = _pool_map(quantize_layer, params["layers"])
    if quantize_head:
        out["lm_head"] = quantize(np.asarray(params["lm_head"], np.float32),
                                  head_fmt or fmt)
    return out
