"""Model configurations (Llama family) and named presets.

The reference hard-codes its model shapes in the harness (head_dim=128,
32/8 GQA heads, kv 256-4096 — /root/reference/src/kernel_test.h:2,25-27,
/root/reference/src/flash-matrix.cu:76). Here shapes are dataclass configs
(SURVEY §5 "config/flag system"), with presets matching BASELINE.json's
target models.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 4096
    # decode matvecs: quantize activations per-32-block to int8 first
    # (llama.cpp's Q4_K x Q8 decode numerics, ~0.5% per-op rel err)
    x_quant8: bool = False
    # implementation of every kernel-backed op: None = each op's platform
    # choice (utils/platform.py), "xla" = the plain path everywhere (the
    # kernel-free reference chip_smoke.py compares against)
    impl: str | None = None
    # mixture-of-experts (0 = dense MLP); see models/moe.py
    n_experts: int = 0
    n_active_experts: int = 2
    moe_intermediate: int | None = None

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def gqa_ratio(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def num_params(self) -> int:
        """Approximate parameter count (weights only)."""
        d, h = self.dim, self.head_dim
        attn = d * (self.n_heads * h) * 2 + d * (self.n_kv_heads * h) * 2
        if self.is_moe:
            inter = self.moe_intermediate or self.intermediate
            mlp = self.n_experts * (3 * d * inter) + self.n_experts * d
        else:
            mlp = 3 * d * self.intermediate
        per_layer = attn + mlp + 2 * d
        return (self.n_layers * per_layer + 2 * self.vocab_size * d + d)


# BASELINE.json config models. TinyLlama-1.1B (config 2), Llama-2-7B-shaped
# (configs 3-4), Llama-2-70B-shaped (config 5), plus a CI-sized debug model.
PRESETS = {
    "debug": ModelConfig(
        name="debug", vocab_size=512, dim=256, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=512, head_dim=64, max_seq_len=512),
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", vocab_size=32000, dim=2048, n_layers=22,
        n_heads=32, n_kv_heads=4, intermediate=5632, head_dim=64,
        max_seq_len=2048),
    "llama2-7b": ModelConfig(
        name="llama2-7b", vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, intermediate=11008, head_dim=128),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, intermediate=14336, head_dim=128,
        rope_theta=500000.0, max_seq_len=8192),
    "llama2-70b": ModelConfig(
        name="llama2-70b", vocab_size=32000, dim=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, intermediate=28672, head_dim=128),
    "moe-debug": ModelConfig(
        name="moe-debug", vocab_size=512, dim=256, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=512, head_dim=64, max_seq_len=512,
        n_experts=4, n_active_experts=2),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, intermediate=14336, head_dim=128,
        rope_theta=1e6, max_seq_len=32768, n_experts=8,
        n_active_experts=2),
}
