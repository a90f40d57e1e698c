"""Benchmark machinery: warmup/repeat wall-clock timing + roofline math.

The analog of the reference's measurement rigs — cudaEvent timing with
warmup/repeat discipline (/root/reference/src/misc/tensor-core.cu:41-73),
"cuda time" prints (/root/reference/src/kernel_test.h:204-228), TFLOPS
(/root/reference/src/misc/cudaTensorCoreGemm.cu:406-407) and GB/s
(/root/reference/src/misc/transpose.cu:50-62) reporting — with the roofline
% computed against the chip's peak HBM bandwidth (BASELINE.md's primary
metric).
"""

from __future__ import annotations

import dataclasses
import time

import jax

from ggml_cuda_experiments_tpu.utils.device_info import chip_spec, has_spec


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds_per_iter: float
    iters: int
    bytes_per_iter: float = 0.0
    flops_per_iter: float = 0.0

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes_per_iter / self.seconds_per_iter / 1e9

    @property
    def tflops(self) -> float:
        return self.flops_per_iter / self.seconds_per_iter / 1e12

    def roofline_bw_pct(self, device=None) -> float:
        spec = chip_spec(device)
        return 100.0 * (self.bytes_per_iter / self.seconds_per_iter
                        ) / spec.hbm_bytes_per_s

    def roofline_flops_pct(self, device=None) -> float:
        spec = chip_spec(device)
        return 100.0 * (self.flops_per_iter / self.seconds_per_iter
                        ) / spec.peak_flops_bf16

    def report(self) -> str:
        """One line; roofline shares only on a device with published
        peaks (a CPU time is never written against a device peak)."""
        parts = [f"{self.name}: {self.seconds_per_iter*1e3:.3f} ms/iter"]
        peaks = has_spec()
        if self.bytes_per_iter:
            parts.append(f"{self.gbytes_per_s:.1f} GB/s")
            if peaks:
                parts.append(f"({self.roofline_bw_pct():.1f}% HBM peak)")
        if self.flops_per_iter:
            parts.append(f"{self.tflops:.2f} TFLOP/s")
            if peaks:
                parts.append(f"({self.roofline_flops_pct():.1f}% bf16 peak)")
        return "  ".join(parts)


def bench(fn, *args, warmup: int = 3, iters: int = 20, name: str = "bench",
          bytes_per_iter: float = 0.0, flops_per_iter: float = 0.0
          ) -> BenchResult:
    """Time ``fn(*args)`` with warmup + block_until_ready discipline."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return BenchResult(name=name, seconds_per_iter=dt, iters=iters,
                       bytes_per_iter=bytes_per_iter,
                       flops_per_iter=flops_per_iter)
