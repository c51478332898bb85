"""Triton kernel (Pallas, ``backend="triton"``) for the WLS tridiagonal solve.

The fast global smoother (``ops/wls.py``) spends its time in 1-D Thomas
solves. As ``lax.scan`` each solve is one dependent step per pixel of the
solve axis, and on the GPU every step is at least one kernel launch. Here
one program owns ``BLOCK_N`` independent systems (adjacent columns of the
(C, S, N) slab, so every load is one coalesced run) and walks the solve axis
inside the kernel: forward elimination, then back substitution. The eliminated
superdiagonal is shared by the C right-hand sides, so the numerator and the
confidence of the WLS filter are solved in one pass.

Loads of ``STEP_BLOCK`` consecutive steps are issued together before their
arithmetic, so the latency of device memory is paid once per block of steps
and not once per step. The slab is zero-padded to whole blocks: a zero
weight decouples a row (a = c = 0, so cp = 0 and denom = 1), which the carry
crosses unchanged in both sweeps.

Per step the arithmetic is that of ``ops.wls._tridiagonal_smooth_rows``,
operation for operation; results differ from it only by FMA contraction
(tested in interpret mode, and on the card at 1e-5 relative).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_N = 32       # systems per program: one warp, one 128-byte load per row
STEP_BLOCK = 8     # steps whose loads are issued together


def _fgs_kernel(lam_ref, wp_ref, wn_ref, f_ref, u_ref, cp_ref, *,
                channels: int, S: int, N: int, barrier: bool):
    """``u_ref`` holds dp after the forward sweep and u after the backward
    one; ``cp_ref`` is the eliminated superdiagonal (scratch)."""
    cols = pl.program_id(0) * BLOCK_N + jnp.arange(BLOCK_N)
    lam = lam_ref[...]
    plane = S * N

    def fwd(i, carry):
        cp_prev, dps = carry[0], list(carry[1:])
        s0 = i * STEP_BLOCK
        idx = [(s0 + k) * N + cols for k in range(STEP_BLOCK)]
        wps = [plgpu.load(wp_ref.at[j]) for j in idx]
        wns = [plgpu.load(wn_ref.at[j]) for j in idx]
        fs = [[plgpu.load(f_ref.at[ch * plane + j]) for j in idx]
              for ch in range(channels)]
        for k in range(STEP_BLOCK):
            a = -lam * wps[k]
            c = -lam * wns[k]
            b = 1.0 - a - c
            denom = b - a * cp_prev
            cp_prev = c / denom
            plgpu.store(cp_ref.at[idx[k]], cp_prev)
            for ch in range(channels):
                dps[ch] = (fs[ch][k] - a * dps[ch]) / denom
                plgpu.store(u_ref.at[ch * plane + idx[k]], dps[ch])
        return (cp_prev, *dps)

    zero = jnp.zeros((BLOCK_N,), jnp.float32)
    n_blocks = S // STEP_BLOCK
    jax.lax.fori_loop(0, n_blocks, fwd, (zero,) * (1 + channels))
    if barrier:      # the interpreter runs in order and has no barrier
        plgpu.debug_barrier()

    def bwd(i, us):
        us = list(us)
        s0 = (n_blocks - 1 - i) * STEP_BLOCK
        idx = [(s0 + k) * N + cols for k in range(STEP_BLOCK)]
        cps = [plgpu.load(cp_ref.at[j]) for j in idx]
        dps = [[plgpu.load(u_ref.at[ch * plane + j]) for j in idx]
               for ch in range(channels)]
        for k in range(STEP_BLOCK - 1, -1, -1):
            for ch in range(channels):
                us[ch] = dps[ch][k] - cps[k] * us[ch]
                plgpu.store(u_ref.at[ch * plane + idx[k]], us[ch])
        return tuple(us)

    jax.lax.fori_loop(0, n_blocks, bwd, (zero,) * channels)


@functools.partial(jax.jit, static_argnames=("interpret",))
def fgs_solve_triton(f: jnp.ndarray, w: jnp.ndarray, lam,
                     interpret: bool = False) -> jnp.ndarray:
    """Solve (I + lam*A) u = f along axis 1 of a (C, S, N) slab.

    ``w`` (S-1, N): edge weights between scan rows s and s+1 (A is the
    weighted 1-D Laplacian with Neumann ends). ``lam`` is a traced scalar,
    so every FGS iteration shares one compiled kernel.
    """
    f = jnp.asarray(f, jnp.float32)
    C, S, N = f.shape
    Sp = -(-S // STEP_BLOCK) * STEP_BLOCK
    Np = -(-N // BLOCK_N) * BLOCK_N
    z = jnp.zeros((1, N), jnp.float32)
    w = jnp.asarray(w, jnp.float32)
    pad = ((0, Sp - S), (0, Np - N))
    wp = jnp.pad(jnp.concatenate([z, w], axis=0), pad)   # to predecessor
    wn = jnp.pad(jnp.concatenate([w, z], axis=0), pad)   # to successor
    fp = jnp.pad(f, ((0, 0),) + pad)
    lam_arr = jnp.asarray(lam, jnp.float32).reshape(())
    u, _ = pl.pallas_call(
        functools.partial(_fgs_kernel, channels=C, S=Sp, N=Np,
                          barrier=not interpret),
        grid=(Np // BLOCK_N,),
        out_shape=(jax.ShapeDtypeStruct((C * Sp * Np,), jnp.float32),
                   jax.ShapeDtypeStruct((Sp * Np,), jnp.float32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="fgs_solve",
    )(lam_arr, wp.reshape(-1), wn.reshape(-1), fp.reshape(-1))
    return u.reshape(C, Sp, Np)[:, :S, :N]
