"""SGM aggregation on the GPU: the CUDA kernel of ``ops/cuda/sgm.cu``.

The kernel is built with ``nvcc`` for ``sm_90a`` from the committed source on
first use, into ``ops/cuda/build/`` (git-ignored), and registered as the XLA
FFI target ``smt_sgm_aggregate``. On the GPU a failed build raises; there is
no fallback. On the CPU :func:`sgm_paths` runs the plain reference
(``ops/sgm.py``) and nothing is built.

Layout: the pipeline's volumes are (D, H, W); the kernel reads (H, W, D), so
that each step of a path loads one contiguous run of D costs. The wrapper
transposes at its boundary and widens int16 volumes to float32 (all census
costs and path totals are integers below 2**24, so the widening is exact).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

from stereo_match.ops import sgm as sgm_ref
from stereo_match.utils.backend import gpu_kernels

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cuda", "sgm.cu")
_BUILD_DIR = os.path.join(_HERE, "cuda", "build")
_TARGET = "smt_sgm_aggregate"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_DISPARITIES = 512

_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the GPU SGM kernel needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Build the kernel library if needed; return its path.

    The file name carries a hash of the source and flags, so an edit
    rebuilds and concurrent builds never see a half-written file.
    """
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(_BUILD_DIR, f"libsmt_sgm_{key.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(library_path())
        jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(
            lib.SmtSgmAggregate), platform="CUDA")
        _registered = True


def _ffi_sgm(cost_hwd, total_hwd, carry_wd, p1, p2, mask):
    """The FFI call: (H, W, D) f32 cost -> ((H, W, D) total, (8, W, D)
    carry). ``total_hwd`` None starts the total at zero."""
    H, W, D = cost_hwd.shape
    if D > MAX_DISPARITIES:
        raise ValueError(f"the GPU SGM kernel takes at most "
                         f"{MAX_DISPARITIES} disparities, got {D}")
    _register()
    out_types = (jax.ShapeDtypeStruct((H, W, D), jnp.float32),
                 jax.ShapeDtypeStruct((8, W, D), jnp.float32))
    if total_hwd is None:
        total_hwd = jnp.zeros((1,), jnp.float32)
        aliases = None
    else:
        aliases = {1: 0}
    call = jax.ffi.ffi_call(_TARGET, out_types, vmap_method="sequential",
                            input_output_aliases=aliases)
    return call(cost_hwd, total_hwd, carry_wd, p1=np.float32(p1),
                p2=np.float32(p2), directions=np.int64(mask))


def _kernel_paths(cost, p1, p2, directions, total, init_carry, call):
    """The (D, H, W) contract of :func:`ops.sgm.sgm_paths` through a kernel
    ``call`` in (H, W, D) layout: transposes, widening and carries."""
    cost = jnp.asarray(cost)
    if cost.dtype not in (jnp.float32, jnp.int16):
        cost = cost.astype(jnp.float32)
    dtype = cost.dtype
    D, H, W = cost.shape
    mask = sgm_ref.directions_mask(directions)
    cost_hwd = jnp.transpose(cost, (1, 2, 0)).astype(jnp.float32)
    total_hwd = None if total is None else jnp.transpose(
        jnp.asarray(total), (1, 2, 0)).astype(jnp.float32)
    carry = jnp.zeros((8, W, D), jnp.float32) if init_carry is None \
        else jnp.swapaxes(jnp.asarray(init_carry), 1, 2).astype(jnp.float32)
    tot, cout = call(cost_hwd, total_hwd, carry, p1, p2, mask)
    return (jnp.transpose(tot, (2, 0, 1)).astype(dtype),
            jnp.swapaxes(cout, 1, 2).astype(dtype))


def sgm_paths(cost, p1: float, p2: float, directions,
              total=None, init_carry=None):
    """:func:`ops.sgm.sgm_paths` on the device's own path: the CUDA kernel
    on the GPU, the plain reference elsewhere."""
    if gpu_kernels("sgm"):
        return _kernel_paths(cost, p1, p2, directions, total, init_carry,
                             _ffi_sgm)
    return sgm_ref.sgm_paths(cost, p1, p2, directions, total, init_carry)


@functools.partial(jax.jit, static_argnames=("p1", "p2", "num_paths"))
def sgm_aggregate_auto(cost, p1: float, p2: float, num_paths: int = 8):
    """S(p, d) = sum_r L_r(p, d) over the first ``num_paths`` directions:
    the CUDA kernel on the GPU, else the plain reference."""
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    return sgm_paths(cost, p1, p2, range(num_paths))[0]
