"""Card-only checks: the Triton kernels compiled for the GPU (no interpret
mode) against the plain path, at small shapes. They skip on the CPU, where
the suite runs; ``python chip_smoke.py`` runs them on the card (phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py")


def test_qmatmul_compiled(rng, gpu):
    from ggml_cuda_experiments_tpu.ops import quant_matmul as qm
    for fmt in ("q8_0", "q4_0", "q4_k"):
        ql = qm.quantize(rng.normal(size=(256, 1024)).astype(np.float32),
                         fmt)
        x = jnp.asarray(rng.normal(size=(3, 1024)), jnp.bfloat16)
        got = qm.qmatmul(x, ql, impl="kernel", out_dtype=jnp.float32)
        want = qm.qmatmul(x, ql, impl="xla", out_dtype=jnp.float32)
        scale = float(jnp.abs(want).max())
        assert float(jnp.abs(got - want).max()) < 2e-2 * scale, fmt


def test_flash_decode_compiled(rng, gpu):
    from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode
    q = jnp.asarray(rng.normal(size=(2, 8, 64)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(2, 2, 2, 256, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(2, 2, 2, 256, 64)), jnp.bfloat16)
    lens = jnp.asarray([1, 200], jnp.int32)
    got = flash_decode(q, k, v, lens, layer=1, impl="kernel")
    want = flash_decode(q, k, v, lens, layer=1, impl="xla")
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_paged_decode_compiled(rng, gpu):
    from ggml_cuda_experiments_tpu.ops.paged_attention import paged_decode
    q = jnp.asarray(rng.normal(size=(2, 8, 64)), jnp.bfloat16)
    kp = jnp.asarray(rng.normal(size=(2, 9, 2, 64, 64)), jnp.bfloat16)
    vp = jnp.asarray(rng.normal(size=(2, 9, 2, 64, 64)), jnp.bfloat16)
    lens = jnp.asarray([3, 250], jnp.int32)
    pidx = jnp.asarray(rng.permutation(8).reshape(2, 4), jnp.int32)
    got = paged_decode(q, kp, vp, lens, pidx, layer=1, impl="kernel")
    want = paged_decode(q, kp, vp, lens, pidx, layer=1, impl="xla")
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
