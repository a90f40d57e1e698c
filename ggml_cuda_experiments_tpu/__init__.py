"""ggml_cuda_experiments_tpu — a JAX quantized-inference kernel engine.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
FSSRepo/ggml-cuda-experiments (a CUDA/WMMA flash-attention kernel laboratory,
see /root/reference), run on NVIDIA GPUs through JAX: fused attention
with online softmax + GQA, split-KV flash decoding with an associative
log-sum-exp merge, GGML-style block quantization (Q8_0/Q4_0/Q4_K) fused into
matmul/matvec, an INT8-quantized paged KV cache, and mesh-sharded multi-chip
execution over NVLink/NCCL collectives — plus the CPU-oracle correctness harness and
benchmark rig the reference embeds in its test executables.

Subpackages
-----------
- ``ops``      Pallas (Triton route) kernels and their plain-XLA twins
               (dequant-matvec, flash decode, paged decode), prefill
               attention, and the LSE-merge primitive.
- ``oracle``   Pure NumPy/jnp reference implementations (the analog of the
               reference's CPU oracle in ``src/utils.h``).
- ``models``   Model definitions (Llama family) and the decode engine.
- ``parallel`` Mesh construction, sharding rules, ring attention,
               continuous batching.
- ``utils``    Tensor I/O, device info, test harness, benchmark machinery.
"""

__version__ = "0.1.0"
