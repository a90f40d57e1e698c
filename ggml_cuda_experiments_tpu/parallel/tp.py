"""Tensor + data parallel model execution via shard_map over a (data, model)
mesh.

Megatron-style sharding, chosen for GQA co-location (boom guide §14): each
``model`` shard owns ``n_kv_heads / n_model`` KV heads together with their
whole GQA group of query heads, so attention (prefill AND decode, kernel
or plain path) runs with ZERO communication; the only collectives in the
forward pass are one psum after the attention output projection and one
after the MLP down projection (row-parallel contractions), riding NVLink.

Layout per layer (N = out features, K = in features; all weights [N, K]):
    wq/wk/wv    column-parallel  P("model", None)   heads sharded
    wo          row-parallel     P(None, "model")   psum after
    w_gate/w_up column-parallel  P("model", None)   intermediate sharded
    w_down      row-parallel     P(None, "model")   psum after
    lm_head     column-parallel  P("model", None)   logits sharded -> out spec
    embed/norms replicated
    kv cache    P(None, "data", "model", None, None)  heads sharded

Quantized (QuantLinear) leaves shard the same way on their N dimension.
Row-parallel quantized layers shard the K dimension, which interacts with
the interleaved column order — use ``shard_quant_linear`` (below), which
re-encodes each K-slice as a standalone interleaved block so every shard is
a self-contained QuantLinear over its logical K-slice.

The reference has no analog (single-process; its one multi-GPU sample does
host-mediated data parallelism only, /root/reference/src/misc/
simpleMultiGPU.cu:155-190) — this is SURVEY §7 R7.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ggml_cuda_experiments_tpu.models import llama
from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.ops.quant_matmul import QuantLinear, from_oracle
from ggml_cuda_experiments_tpu.oracle import quant as quant_ref
from ggml_cuda_experiments_tpu.utils import native as _native

_COL = ("wq", "wk", "wv", "w_gate", "w_up")     # shard N (dim 0)
_ROW = ("wo", "w_down")                          # shard K (dim 1)


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------

def _linear_spec(w, axis: int):
    """Spec tree for a dense array or QuantLinear linear layer."""
    if isinstance(w, QuantLinear):
        sub = P("model", None) if axis == 0 else P(None, "model")
        return QuantLinear(
            fmt=w.fmt, shape=w.shape, enc=w.enc,
            qs=sub,
            d=None if w.d is None else sub,
            es=None if w.es is None else sub,
            em=None if w.em is None else sub,
            qh=None if w.qh is None else sub,
        )
    return P("model", None) if axis == 0 else P(None, "model")


def param_specs(params: llama.Params) -> llama.Params:
    """PartitionSpec pytree matching the params tree."""
    specs = {
        "embed": P(None, None),
        "final_norm": P(None),
        "lm_head": _linear_spec(params["lm_head"], 0),
        "layers": [],
    }
    for layer in params["layers"]:
        ls = {}
        for key in _COL:
            ls[key] = _linear_spec(layer[key], 0)
        for key in _ROW:
            ls[key] = _linear_spec(layer[key], 1)
        ls["attn_norm"] = P(None)
        ls["mlp_norm"] = P(None)
        specs["layers"].append(ls)
    return specs


def cache_specs() -> llama.KVCache:
    return llama.KVCache(
        k=P(None, "data", "model", None, None),
        v=P(None, "data", "model", None, None),
        lengths=P("data"),
    )


def shard_params(params: llama.Params, mesh: Mesh) -> llama.Params:
    """device_put the params with their NamedShardings."""
    specs = param_specs(params)
    return jax.tree.map(
        lambda w, s: jax.device_put(w, NamedSharding(mesh, s)),
        params, specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_quant_linear(w: np.ndarray, fmt: str, k_shards: int) -> QuantLinear:
    """Quantize a row-parallel weight so each K-shard is a standalone
    interleaved block (the global array is the concat of per-shard
    encodings, so P(None, "model") slices it into valid local tensors)."""
    n, k = w.shape
    assert k % k_shards == 0
    kl = k // k_shards
    parts = [from_oracle(_native.quantize(w[:, i * kl:(i + 1) * kl], fmt))
             for i in range(k_shards)]
    def cat(field):
        vals = [getattr(p, field) for p in parts]
        if vals[0] is None:
            return None
        return jnp.concatenate(vals, axis=1)

    return QuantLinear(fmt=fmt, shape=(n, k), enc=parts[0].enc,
                       qs=cat("qs"), d=cat("d"),
                       es=cat("es"), em=cat("em"), qh=cat("qh"))


def quantize_params_sharded(params: llama.Params, fmt: str, n_model: int
                            ) -> llama.Params:
    """Quantize linears for an n_model-way TP run (row-parallel layers get
    the per-shard interleaved encoding).

    The MLP intermediate dimension is zero-padded so each w_down K-shard is
    a whole number of quantization superblocks (e.g. 7B's 11008 -> 11264
    for 4-way TP): zero columns quantize to d=0 blocks and contribute
    nothing, and silu(0)*0 == 0 keeps the padded lanes inert.
    """
    gran = quant_ref.QK_K * n_model
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ls = dict(layer)
        inter = layer["w_gate"].shape[0]
        inter_p = -(-inter // gran) * gran

        def qcol(w, pad_rows=0):
            w = np.asarray(w, np.float32)
            if pad_rows:
                w = np.pad(w, ((0, pad_rows), (0, 0)))
            return from_oracle(_native.quantize(w, fmt))

        ls["wq"] = qcol(layer["wq"])
        ls["wk"] = qcol(layer["wk"])
        ls["wv"] = qcol(layer["wv"])
        ls["w_gate"] = qcol(layer["w_gate"], inter_p - inter)
        ls["w_up"] = qcol(layer["w_up"], inter_p - inter)
        ls["wo"] = shard_quant_linear(
            np.asarray(layer["wo"], np.float32), fmt, n_model)
        w_down = np.asarray(layer["w_down"], np.float32)
        w_down = np.pad(w_down, ((0, 0), (0, inter_p - inter)))
        ls["w_down"] = shard_quant_linear(w_down, fmt, n_model)
        out["layers"].append(ls)
    out["lm_head"] = from_oracle(
        _native.quantize(np.asarray(params["lm_head"], np.float32), fmt))
    return out


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def local_config(cfg: ModelConfig, n_model: int) -> ModelConfig:
    assert cfg.n_kv_heads % n_model == 0, (
        f"model axis {n_model} must divide n_kv_heads {cfg.n_kv_heads} "
        "(GQA co-location)")
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // n_model,
        n_kv_heads=cfg.n_kv_heads // n_model,
    )


def make_tp_step(cfg: ModelConfig, mesh: Mesh, params: llama.Params,
                 *, decode: bool):
    """Build a jitted shard_map-ed step.

    decode=True:  (params, tokens [B], cache)     -> (logits [B, V], cache)
    decode=False: (params, tokens [B, T], cache)  -> (logits [B, V], cache)
    """
    n_model = mesh.shape["model"]
    lcfg = local_config(cfg, n_model)
    pspecs = param_specs(params)
    cspecs = cache_specs()
    tok_spec = P("data") if decode else P("data", None)

    def step(params, tokens, cache):
        if decode:
            positions = cache.lengths[:, None]
            toks = tokens[:, None]
        else:
            B, T = tokens.shape
            positions = jnp.broadcast_to(
                jnp.arange(T, dtype=jnp.int32), (B, T))
            toks = tokens
        logits, new_cache = llama._forward(
            params, lcfg, toks, cache, positions, decode=decode,
            reduce_axis="model")
        return logits, new_cache

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(pspecs, tok_spec, cspecs),
        out_specs=(P("data", "model"), cspecs),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(2,))


def create_sharded_cache(cfg: ModelConfig, mesh: Mesh, batch: int,
                         max_len: int, dtype=jnp.bfloat16) -> llama.KVCache:
    cache = llama.KVCache.create(cfg, batch, max_len, dtype)
    cs = cache_specs()
    return llama.KVCache(
        k=jax.device_put(cache.k, NamedSharding(mesh, cs.k)),
        v=jax.device_put(cache.v, NamedSharding(mesh, cs.v)),
        lengths=jax.device_put(cache.lengths, NamedSharding(mesh, cs.lengths)),
    )
