"""Multi-device data-parallel reduction — the analog of the reference's
``simpleMultiGPU.cu`` (/root/reference/src/misc/simpleMultiGPU.cu:43-218):
a large summation sharded by range across devices, per-device partial
reduction, merged, and checked against the CPU at rel-diff < 1e-5 (the
reference's gate, simpleMultiGPU.cu:205-218).

The twist: the merge rides a device collective (``psum`` under
``shard_map``) instead of the reference's host-side loop — both variants
are tested and must agree."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


N = 1 << 23        # 8M elements (reference uses 32M across up to 32 GPUs)


def _data():
    rng = np.random.default_rng(7)
    return rng.random(N).astype(np.float32)


def test_psum_reduction_matches_host():
    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("data",))
    x = _data()
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P())
    def device_sum(v):
        return jax.lax.psum(jnp.sum(v, keepdims=True), "data")

    got = float(device_sum(xs)[0])
    want = float(np.sum(x, dtype=np.float64))
    assert abs(got - want) / abs(want) < 1e-5     # reference's gate


def test_host_merge_agrees_with_collective():
    """The reference merges per-device partials on the host
    (simpleMultiGPU.cu:155-190); the partial-per-device path must agree
    with the collective."""
    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("data",))
    x = _data()
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    def partials(v):
        return jnp.sum(v, keepdims=True)          # one partial per device

    per_dev = np.asarray(partials(xs))            # host-side merge below
    assert per_dev.shape == (len(devs),)
    host_merged = float(per_dev.sum(dtype=np.float64))

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P())
    def collective(v):
        return jax.lax.psum(jnp.sum(v, keepdims=True), "data")

    got = float(collective(xs)[0])
    np.testing.assert_allclose(got, host_merged, rtol=1e-6)
