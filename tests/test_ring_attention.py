"""Context parallelism on the virtual 8-device mesh: ring attention
(prefill) and pmax/psum-merged decode must equal the single-device kernels."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ggml_cuda_experiments_tpu.parallel.ring_attention import (
    decode_context_parallel, ring_attention,
)
from ggml_cuda_experiments_tpu.ops.attention import attention
from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu.utils.harness import assert_close


def _ctx_mesh(n=4):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("ctx",))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_single(rng, causal):
    B, H, S, D, n = 1, 4, 512, 64, 4
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)

    want = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)

    mesh = _ctx_mesh(n)
    f = shard_map(
        lambda q, k, v: ring_attention(q, k, v, "ctx", causal=causal),
        mesh=mesh,
        in_specs=(P(None, None, "ctx", None),) * 3,
        out_specs=P(None, None, "ctx", None),
        check_vma=False,
    )
    got = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert_close(np.asarray(got), np.asarray(want), atol=2e-3, rtol=2e-3,
                 name=f"ring causal={causal}")


def test_decode_context_parallel_matches_single(rng):
    B, Hq, Hkv, S, D, n = 2, 8, 4, 1024, 64, 4
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lengths = np.array([300, 1024], np.int32)   # seq 0 lives in shards 0-1

    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lengths))

    S_loc = S // n
    # per-shard valid lengths: clamp(length - shard*S_loc, 0, S_loc)
    def local_lengths(lengths):
        shard = jax.lax.axis_index("ctx")
        return jnp.clip(lengths - shard * S_loc, 0, S_loc)

    mesh = _ctx_mesh(n)
    f = shard_map(
        lambda q, k, v, lens: decode_context_parallel(
            q, k, v, local_lengths(lens), "ctx"),
        mesh=mesh,
        in_specs=(P(), P(None, None, "ctx", None), P(None, None, "ctx", None),
                  P()),
        out_specs=P(),
        check_vma=False,
    )
    got = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths))
    assert_close(np.asarray(got), np.asarray(want), atol=2e-3, rtol=2e-3,
                 name="ctx-parallel decode")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_single(rng, causal):
    """Ulysses all-to-all sequence parallelism == single-device attention."""
    from ggml_cuda_experiments_tpu.parallel.ring_attention import ulysses_attention
    B, H, S, D, n = 1, 8, 512, 64, 4
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    want = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    mesh = _ctx_mesh(n)
    f = shard_map(
        lambda q, k, v: ulysses_attention(q, k, v, "ctx", causal=causal),
        mesh=mesh,
        in_specs=(P(None, None, "ctx", None),) * 3,
        out_specs=P(None, None, "ctx", None),
        check_vma=False,
    )
    got = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert_close(np.asarray(got), np.asarray(want), atol=2e-3, rtol=2e-3,
                 name=f"ulysses causal={causal}")
