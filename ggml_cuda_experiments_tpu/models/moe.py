"""Mixture-of-Experts MLP block with expert parallelism.

The reference is dense-only (no MoE anywhere in /root/reference); this is
part of the driver-mandated parallelism surface (tp/pp/dp/sp/ep). The block
keeps static shapes:

- **Dense dispatch, not gather/scatter.** For decode-sized token counts the
  number of tokens is far below the expert count x intermediate size, so
  routing via dynamic gathers (the GPU idiom) would force dynamic shapes XLA
  cannot tile well. Instead every (local) expert runs on every token
  as one stacked batched matmul — static shapes, tensor-core friendly — and the
  router's top-k weights (zero for unselected experts) fold the results.
  FLOP "waste" is E_local/k, but decode matvecs are HBM-bound: bytes
  streamed per device are exactly the local experts' weights, which is the
  same as perfectly-routed execution and 1/ep of the full model.
- **Expert parallelism = shard the expert axis.** Expert weights carry a
  leading E dim sharded over the ``expert`` mesh axis; each device computes
  its E/ep experts and one ``psum`` folds the weighted partial outputs.
  (Token-permuting all_to_all dispatch only wins when tokens >> experts —
  a prefill-side optimization, not the decode path.)
- Router math in f32 (softmax over experts is tiny but precision-critical
  for top-k stability).

Weights per MoE layer (leading dim E = n_experts):
    router          [E, dim]            dense (replicated)
    w_gate, w_up    [E, inter, dim]     dense bf16 or stacked QuantLinear
    w_down          [E, dim, inter]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.ops.quant_matmul import QuantLinear


def _expert_slice(w, e: int):
    """Expert e's weight from a stacked leaf (dense [E, N, K] array or
    QuantLinear whose arrays carry a leading E dim)."""
    if isinstance(w, QuantLinear):
        return QuantLinear(
            fmt=w.fmt, shape=w.shape,
            qs=w.qs[e],
            d=None if w.d is None else w.d[e],
            es=None if w.es is None else w.es[e],
            em=None if w.em is None else w.em[e],
            qh=None if w.qh is None else w.qh[e],
        )
    return w[e]


def stack_expert_quant(qls: list[QuantLinear]) -> QuantLinear:
    """Stack per-expert QuantLinears into one leading-E pytree (the form
    ``_expert_slice`` unstacks and the ``expert`` mesh axis shards)."""
    ref = qls[0]

    def cat(field):
        vals = [getattr(q, field) for q in qls]
        return None if vals[0] is None else jnp.stack(vals)

    return QuantLinear(fmt=ref.fmt, shape=ref.shape, qs=cat("qs"),
                       d=cat("d"), es=cat("es"), em=cat("em"),
                       qh=cat("qh"))


def n_local_experts(w) -> int:
    return w.qs.shape[0] if isinstance(w, QuantLinear) else w.shape[0]


def router_topk(logits: jax.Array, k: int) -> jax.Array:
    """Top-k routing weights: softmax over experts, keep the k largest,
    renormalize (Mixtral convention). logits [..., E] -> weights [..., E]
    with exactly k nonzeros per token."""
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    topv, _ = jax.lax.top_k(probs, k)
    thresh = topv[..., -1:]
    kept = jnp.where(probs >= thresh, probs, 0.0)
    return kept / jnp.sum(kept, axis=-1, keepdims=True)


def moe_mlp(layer, cfg: ModelConfig, x: jax.Array, *,
            expert_axis: str | None = None, xq8: bool = False) -> jax.Array:
    """MoE feed-forward on normalized input x [..., dim].

    ``expert_axis``: shard_map axis name over which the expert dim of the
    stacked weights is sharded; the router (replicated) still scores ALL
    experts, each device folds only its local slice, and one psum merges.
    """
    from ggml_cuda_experiments_tpu.models import llama

    e_total = cfg.n_experts
    router_logits = jnp.einsum(
        "...d,ed->...e", x.astype(jnp.float32),
        layer["router"].astype(jnp.float32))
    weights = router_topk(router_logits, cfg.n_active_experts)  # [..., E]

    e_local = n_local_experts(layer["w_gate"])
    if expert_axis is not None:
        e0 = jax.lax.axis_index(expert_axis) * e_local
    else:
        assert e_local == e_total, (
            f"{e_local} local experts vs n_experts={e_total} "
            "outside shard_map")
        e0 = 0

    out = jnp.zeros((*x.shape[:-1], cfg.dim), jnp.float32)
    for e in range(e_local):
        gate = llama.apply_linear(x, _expert_slice(layer["w_gate"], e),
                                  xq8=xq8)
        up = llama.apply_linear(x, _expert_slice(layer["w_up"], e), xq8=xq8)
        h = jax.nn.silu(gate.astype(jnp.float32)).astype(x.dtype) \
            * up.astype(x.dtype)
        y = llama.apply_linear(h, _expert_slice(layer["w_down"], e), xq8=xq8)
        w_e = jax.lax.dynamic_index_in_dim(
            weights, e0 + e, axis=-1, keepdims=True)
        out = out + w_e * y.astype(jnp.float32)

    if expert_axis is not None:
        out = jax.lax.psum(out, expert_axis)
    return out.astype(x.dtype)


def init_moe_weights(cfg: ModelConfig, seed: int = 0,
                     dtype=jnp.bfloat16):
    """Random MoE model weights (router + stacked experts per layer);
    attention weights identical in structure to the dense model."""
    from ggml_cuda_experiments_tpu.models import llama
    import numpy as np

    params = llama.init_weights(cfg, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed + 17)
    inter = cfg.moe_intermediate or cfg.intermediate
    E, d = cfg.n_experts, cfg.dim

    def lin(*shape):
        k = shape[-1]
        return jnp.asarray(
            rng.normal(size=shape).astype(np.float32) / np.sqrt(k), dtype)

    for layer in params["layers"]:
        for key in ("w_gate", "w_up", "w_down"):
            layer.pop(key)
        layer["router"] = lin(E, d)
        layer["w_gate"] = lin(E, inter, d)
        layer["w_up"] = lin(E, inter, d)
        layer["w_down"] = lin(E, d, inter)
    return params


def moe_mlp_oracle(layer, cfg: ModelConfig, x) -> jax.Array:
    """NumPy-style dense reference: full softmax/top-k routing, every
    expert evaluated, f32 throughout (the CPU oracle for tests)."""
    import numpy as np

    xf = np.asarray(x, np.float32)
    logits = xf @ np.asarray(layer["router"], np.float32).T
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    k = cfg.n_active_experts
    thresh = np.sort(probs, axis=-1)[..., -k][..., None]
    kept = np.where(probs >= thresh, probs, 0.0)
    weights = kept / kept.sum(-1, keepdims=True)

    out = np.zeros_like(xf)
    for ei in range(cfg.n_experts):
        wg = np.asarray(layer["w_gate"][ei], np.float32)
        wu = np.asarray(layer["w_up"][ei], np.float32)
        wd = np.asarray(layer["w_down"][ei], np.float32)
        g = xf @ wg.T
        h = (g / (1 + np.exp(-g))) * (xf @ wu.T)
        out += weights[..., ei:ei + 1] * (h @ wd.T)
    return out
