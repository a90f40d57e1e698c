"""Device/topology introspection — the analog of ``print_cuda_info``
(/root/reference/src/cuda_info.h:3-44): reports the devices and the
published peak rates the roofline reports divide by.
"""

from __future__ import annotations

import dataclasses

import jax


# Published dense peaks per card, keyed by ``device_kind``. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part at its 700 W limit (no
# sparsity): 989 TFLOP/s bf16, 1,979 TOP/s int8 and fp8, 80 GB HBM3 at
# 3.35 TB/s. A card set to a lower power limit cannot hold these rates;
# measurements print the limit beside every number.
_PEAKS = {
    # device_kind: (bf16 FLOP/s, int8/fp8 OP/s, HBM bytes/s, HBM GB)
    "NVIDIA H100 80GB HBM3": (989e12, 1979e12, 3.35e12, 80),
}


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    device_kind: str
    peak_flops_bf16: float
    peak_ops_int8: float
    hbm_bytes_per_s: float
    hbm_gb: float


def has_spec(device: jax.Device | None = None) -> bool:
    d = device or jax.devices()[0]
    return d.device_kind in _PEAKS


def chip_spec(device: jax.Device | None = None) -> ChipSpec:
    """Peak rates of ``device``; a device not in the table is an error."""
    d = device or jax.devices()[0]
    if d.device_kind not in _PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {d.device_kind!r} "
            f"(known: {sorted(_PEAKS)})")
    return ChipSpec(d.device_kind, *_PEAKS[d.device_kind])


def device_summary() -> str:
    lines = [f"backend: {jax.default_backend()}  devices: {jax.device_count()} "
             f"(local {jax.local_device_count()}), processes: {jax.process_count()}"]
    for d in jax.devices():
        line = f"  [{d.id}] {d.device_kind} (process {d.process_index})"
        if has_spec(d):
            spec = chip_spec(d)
            line += (f" peak {spec.peak_flops_bf16/1e12:.0f} TFLOP/s bf16, "
                     f"HBM {spec.hbm_bytes_per_s/1e9:.0f} GB/s / "
                     f"{spec.hbm_gb} GB")
        lines.append(line)
    return "\n".join(lines)
