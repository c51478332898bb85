"""Device-path choice.

Each stage has one device path on the GPU (a CUDA or Triton kernel where one
beats XLA, otherwise XLA's own code) and one plain reference, which is what
runs on the CPU and what the tests compare against. :func:`gpu_kernels` is
the one switch between them. :func:`xla_only` turns kernels off on the GPU,
so that a measurement can time the plain version on the same card.
"""

from __future__ import annotations

import contextlib
import os

import jax

KERNELS = ("sgm", "fgs")
_off: frozenset = frozenset()


def gpu_kernels(name: str) -> bool:
    """True when the default backend is an NVIDIA GPU and kernel ``name``
    (one of :data:`KERNELS`) is on."""
    return name not in _off and jax.default_backend() == "gpu"


@contextlib.contextmanager
def xla_only(*names: str):
    """Trace the plain path of kernels ``names`` (default: all) even on the
    GPU, for kernel-vs-XLA timings on one card.

    The choice is made at trace time, so JAX's caches are cleared on entry
    and exit: programs traced inside do not leak out, nor in.
    """
    global _off
    unknown = set(names) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")
    jax.clear_caches()
    _off = frozenset(names or KERNELS)
    try:
        yield
    finally:
        _off = frozenset()
        jax.clear_caches()


def use_compile_cache() -> str:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says (JAX reads that variable itself), else in a fixed ``.jax_cache/``
    beside the package. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
