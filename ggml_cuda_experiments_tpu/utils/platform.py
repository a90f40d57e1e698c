"""Backend choice: which implementation of an op runs on this machine.

Every op that has a hand-written kernel also has a plain ``jax.numpy`` path.
On the GPU an op runs the implementation that measured fastest on the card
(each op's ``GPU_IMPL``, with its numbers in PERF.md). On the CPU, where the
tests run, it runs the plain path; a test that asks for the kernel
explicitly gets it in Pallas' interpreter. Any other backend is an error,
so nothing silently falls back to the interpreter on an accelerator.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

BACKENDS = ("gpu", "cpu")


def backend() -> str:
    """The JAX default backend, checked against the supported ones."""
    b = jax.default_backend()
    if b not in BACKENDS:
        raise RuntimeError(
            f"unsupported JAX backend {b!r}: this program runs on an NVIDIA "
            "GPU, or on the CPU for tests")
    return b


def resolve_impl(impl: str | None, gpu_impl: str,
                 choices: tuple[str, ...]) -> str:
    """An op's implementation: ``impl`` when given, else ``gpu_impl`` on
    the GPU and the plain ``"xla"`` path on the CPU."""
    if impl is None:
        impl = gpu_impl if backend() == "gpu" else "xla"
    if impl not in choices:
        raise ValueError(f"impl {impl!r} not in {choices}")
    return impl


def interpret() -> bool:
    """Pallas interpret mode: on the CPU only, never on the card."""
    return backend() == "cpu"


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache in ``JAX_COMPILATION_CACHE_DIR``
    when that is set (JAX reads it itself), else in ``<checkout>/.jax_cache``.
    Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
