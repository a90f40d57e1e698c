"""Runtime utilities: backend choice, tensor I/O, harness, benchmarking."""

from ggml_cuda_experiments_tpu.utils.platform import (
    backend,
    resolve_impl,
)
