"""Collective matmul: all-gather / reduce-scatter decomposed into ring
hops overlapped with per-chunk partial GEMMs.

The BASELINE.json north star calls for "all-gather/reduce-scatter
collectives overlapped with Pallas compute". A monolithic ``all_gather``
serializes: comm, then the full dot. Decomposing it into a ring
(`jax.lax.ppermute`, the same point-to-point primitive the context-parallel
ring attention uses, parallel/ring_attention.py) lets hop s+1 ride the
NVLink links while the tensor cores multiply chunk s — the communication disappears under
compute whenever a chunk's dot time exceeds a hop. This is the standard
"collective matmul" / Megatron-SP pattern (PAPERS.md: overlap-collectives);
the reference repo has no analog — its only multi-device code merges on the
host (/root/reference/src/misc/simpleMultiGPU.cu:155-190).

Both functions run *inside* ``shard_map`` over a mesh axis:

- ``matmul_ag(x_shard, w_local, axis)``: sequence-parallel in, tensor-
  parallel out.  x is row-sharded [Bs, K]; the logical op is
  ``all_gather(x) @ W_local^T -> [B, N_loc]``.  Each step dots the chunk it
  holds and forwards it around the ring; the dot covers the hop.
- ``matmul_rs(x, w_local, axis)``: tensor-parallel in, sequence-parallel
  out.  x [B, K] against row-parallel W [N, K_loc... ] produces a partial
  [B, N] whose sum must be re-sharded over rows: the ring reduce-scatter
  computes each per-chunk partial dot *at the step that needs it*, so the
  accumulator hop and the next chunk's GEMM overlap.

Unrolled Python loops (axis size is static under shard_map) give XLA's
latency-hiding scheduler a DAG where each ``ppermute`` has no consumer
until the next iteration — the collective-start/-done pair brackets the
dot, which is exactly the overlap structure.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ring_perm(n: int, reverse: bool = False):
    if reverse:
        return [(i, (i - 1) % n) for i in range(n)]
    return [(i, (i + 1) % n) for i in range(n)]


def matmul_ag(x_shard: jax.Array, w_local: jax.Array, axis_name: str,
              precision=None) -> jax.Array:
    """``all_gather(x_shard, axis) @ w_local^T`` with the gather decomposed
    into ring hops overlapped with chunk GEMMs.

    x_shard: [Bs, K] (this device's rows of the logically [Bs*n, K] x).
    w_local: [N_loc, K] (column-parallel shard).
    Returns [Bs*n, N_loc] — the same rows every device computes, against
    its own N_loc columns.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    bs = x_shard.shape[0]
    nloc = w_local.shape[0]
    out = jnp.zeros((bs * n, nloc), jnp.float32)
    perm = _ring_perm(n, reverse=True)   # receive from (i+1): chunk owners
                                         # walk forward in row order
    chunk = x_shard
    for s in range(n):
        if s < n - 1:                    # comm for step s+1 ...
            nxt = jax.lax.ppermute(chunk, axis_name, perm)
        part = jax.lax.dot_general(      # ... overlaps this dot
            chunk, w_local, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision)
        owner = (idx + s) % n            # whose rows we are holding
        out = jax.lax.dynamic_update_slice(out, part, (owner * bs, 0))
        if s < n - 1:
            chunk = nxt
    return out


def matmul_rs(x: jax.Array, w_local: jax.Array, axis_name: str,
              precision=None) -> jax.Array:
    """``reduce_scatter(x @ w_local^T, axis)`` over output rows, with each
    per-chunk partial GEMM computed at the ring step that consumes it.

    x: [B, K_loc] (this device's K columns of the activations; B % n == 0).
    w_local: [N, K_loc] (row-parallel shard).
    Returns [B/n, N]: rows ``idx*B/n : (idx+1)*B/n`` of the fully-reduced
    product.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    b = x.shape[0]
    assert b % n == 0, f"batch {b} not divisible by axis size {n}"
    bc = b // n
    perm = _ring_perm(n)

    def chunk_dot(t):
        xs = jax.lax.dynamic_slice_in_dim(x, t * bc, bc, axis=0)
        return jax.lax.dot_general(
            xs, w_local, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision)

    # ring reduce-scatter: acc starts at device i targeting chunk (i-1);
    # after n-1 forward hops it lands on its target with all n partials.
    acc = chunk_dot((idx - 1) % n)
    for s in range(1, n):
        acc = jax.lax.ppermute(acc, axis_name, perm)
        acc = acc + chunk_dot((idx - 1 - s) % n)   # dot overlaps the hop
    return acc


def sp_mlp_block(x_shard: jax.Array, w_gate: jax.Array, w_up: jax.Array,
                 w_down: jax.Array, axis_name: str) -> jax.Array:
    """Sequence-parallel SwiGLU MLP (Megatron-SP): activations stay
    token-sharded [Ts, d] at the block boundary; inside, the all-gather
    rides under the gate/up GEMMs and the reduce-scatter under the down
    GEMM — the whole block's communication is hidden by its own compute.

    w_gate/w_up: column-parallel [I_loc, d]; w_down: row-parallel
    [d, I_loc].  Equivalent to the replicated+psum formulation
    (tested in tests/test_collective_matmul.py) with n× less activation
    memory and AG+RS (= psum's cost) fully overlapped.
    """
    gate = matmul_ag(x_shard, w_gate, axis_name)        # [T, I_loc]
    up = matmul_ag(x_shard, w_up, axis_name)            # [T, I_loc]
    h = (jax.nn.silu(gate) * up).astype(x_shard.dtype)
    return matmul_rs(h, w_down, axis_name)              # [Ts, d]
