"""Kernels (Pallas through Triton), their plain-XLA twins, and
kernel-level primitives."""

from ggml_cuda_experiments_tpu.ops.lse import (
    AttnPartial,
    lse_combine,
    lse_combine_stacked,
    lse_finalize,
)
