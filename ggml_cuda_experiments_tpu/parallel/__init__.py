"""Multi-chip execution: mesh construction, tensor/data-parallel model
steps, context-parallel (ring) attention, continuous batching.

The reference's only multi-device code is a host-mediated data-parallel sum
(/root/reference/src/misc/simpleMultiGPU.cu) with no communication backend
(SURVEY §2.3 item 6, §5). The replacement here is built on
``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives (NCCL on the GPU) —
psum for tensor-parallel reductions, ppermute rings for context parallelism.
"""

from ggml_cuda_experiments_tpu.parallel.mesh import make_mesh
