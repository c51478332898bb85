"""Semi-global matching path aggregation (jittable JAX reference path).

Implements the SGM recurrence the reference gets from OpenCV's C++
(implicit behind ``StereoSGBM_create``, params at
``stereo_vision/stereo_vision.py:148-157``):

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

aggregated over ``num_paths`` directions (8, 4, or 2).

Volumes are in planes layout (D, H, W). Every direction is canonicalized to
one primitive -- a scan along axis 1 of a (D, S, N) volume -- by transpose
(horizontal paths), flip (reverse paths), and shear (diagonal paths;
out-of-frame cells are zero-filled, which makes the recurrence self-reset at
the frame boundary since a zero carry contributes exactly 0).

This module is the plain reference and the CPU path. On the GPU the same
recurrence runs as one CUDA kernel per line family
(``ops/sgm_cuda.py``, ``ops/cuda/sgm.cu``), tested against this module. The
row-sharded multi-card variant lives in ``parallel/tiling.py`` and chains
row tiles through :func:`sgm_paths`'s carries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# (dy, dx) path directions, grouped so num_paths in {2, 4, 8} takes a prefix.
PATH_DIRECTIONS_8 = (
    (0, 1), (0, -1),            # horizontal (along the epipolar line)
    (1, 0), (-1, 0),            # vertical
    (1, 1), (-1, -1),           # main diagonal
    (1, -1), (-1, 1),           # anti diagonal
)


def scan_direction(cost: jnp.ndarray, p1: float, p2: float,
                   init_carry: jnp.ndarray | None = None,
                   unroll: int = 8) -> jnp.ndarray:
    """The canonical SGM scan: accumulate along axis 1 of (D, S, N).

    Returns L of the same shape. A slab of zeros behaves as "no
    predecessor" (its contribution to the min is 0 and its own min is 0, so
    the first slab gets L = C) — the property both the shear trick and the
    multi-card carry hand-off rely on. ``init_carry`` (D, N) overrides the
    zero initial carry (used by the sharded scan to chain tiles).
    """
    cost = jnp.asarray(cost)
    if cost.dtype not in (jnp.float32, jnp.int16):
        cost = cost.astype(jnp.float32)
    dt = cost.dtype
    p1 = jnp.asarray(p1, dt)
    p2 = jnp.asarray(p2, dt)
    big = jnp.asarray(30000 if dt == jnp.int16 else 1e9, dt)

    def step(carry, c_slab):
        prev_min = jnp.min(carry, axis=0, keepdims=True)            # (1, N)
        up = jnp.concatenate([jnp.full_like(carry[:1], big),
                              carry[:-1]], axis=0)                  # L(d-1)
        down = jnp.concatenate([carry[1:],
                                jnp.full_like(carry[:1], big)], axis=0)
        m = jnp.minimum(jnp.minimum(carry, prev_min + p2),
                        jnp.minimum(up, down) + p1)
        L = c_slab + m - prev_min
        return L, L

    init = jnp.zeros_like(cost[:, 0]) if init_carry is None else init_carry
    _, out = jax.lax.scan(step, init, jnp.swapaxes(cost, 0, 1), unroll=unroll)
    return jnp.swapaxes(out, 0, 1)


def _shear(volume: jnp.ndarray, direction: int) -> jnp.ndarray:
    """Shear rows of (D, H, W) so diagonal predecessors align vertically.

    direction=+1 aligns (y-1, x-1) above (y, x); -1 aligns (y-1, x+1).
    Returns (D, H, W+H-1) with zeros outside the frame.
    """
    D, H, W = volume.shape
    Ws = W + H - 1
    y = jnp.arange(H)[:, None]
    xs = jnp.arange(Ws)[None, :]
    if direction > 0:
        x = xs - (H - 1 - y)     # column x' holds orig x = x' - (H-1-y)
    else:
        x = xs - y
    valid = (x >= 0) & (x < W)
    xc = jnp.clip(x, 0, W - 1)
    sheared = volume[:, y, xc]   # (D, H, Ws) gather on the lane axis
    return jnp.where(valid[None], sheared, jnp.zeros((), volume.dtype))


def _unshear(sheared: jnp.ndarray, direction: int, W: int) -> jnp.ndarray:
    H = sheared.shape[1]
    y = jnp.arange(H)[:, None]
    xo = jnp.arange(W)[None, :]
    xs = xo + (H - 1 - y) if direction > 0 else xo + y
    return sheared[:, y, xs]


def _shear_carry(carry: jnp.ndarray, direction: int, H: int) -> jnp.ndarray:
    """Place a (D, W) row-above carry into the sheared frame of :func:`_shear`.

    Row -1 of the sheared scan holds original column x' - H (direction +1)
    or x' + 1 (direction -1); columns outside the frame stay zero.
    """
    D, W = carry.shape
    xs = jnp.arange(W + H - 1)
    x = xs - H if direction > 0 else xs + 1
    valid = (x >= 0) & (x < W)
    sheared = carry[:, jnp.clip(x, 0, W - 1)]
    return jnp.where(valid[None], sheared, jnp.zeros((), carry.dtype))


def aggregate_direction(cost: jnp.ndarray, dy: int, dx: int,
                        p1: float, p2: float,
                        init_carry: jnp.ndarray | None = None) -> jnp.ndarray:
    """Aggregate one path direction over a (D, H, W) volume.

    ``init_carry`` (D, W): path values of the row the path enters from
    (row -1 for dy > 0, row H for dy < 0), for chaining row tiles; ignored
    by the horizontal directions.
    """
    if dy < 0:                        # canonicalize to downward scan (y-flip
        flipped = aggregate_direction(cost[:, ::-1], -dy, dx, p1, p2,
                                      init_carry)
        return flipped[:, ::-1]       # keeps dx: a (-1,dx) step becomes (1,dx))
    if dy == 0:                       # horizontal: scan over x
        vol = jnp.swapaxes(cost, 1, 2)    # (D, W, H)
        if dx < 0:
            vol = vol[:, ::-1]
        out = scan_direction(vol, p1, p2)
        if dx < 0:
            out = out[:, ::-1]
        return jnp.swapaxes(out, 1, 2)
    if dx == 0:                       # vertical
        return scan_direction(cost, p1, p2, init_carry)
    # Diagonal: shear so the diagonal becomes a column, scan, unshear.
    sheared = _shear(cost, dx)
    init = None if init_carry is None else _shear_carry(
        jnp.asarray(init_carry, sheared.dtype), dx, cost.shape[1])
    out = scan_direction(sheared, p1, p2, init)
    return _unshear(out, dx, cost.shape[2])


def directions_mask(directions) -> int:
    """Bit mask over :data:`PATH_DIRECTIONS_8` indices."""
    mask = 0
    for i in directions:
        if not 0 <= i < 8:
            raise ValueError(f"direction index {i} not in [0, 8)")
        mask |= 1 << i
    return mask


def sgm_paths(cost: jnp.ndarray, p1: float, p2: float, directions,
              total: jnp.ndarray | None = None,
              init_carry: jnp.ndarray | None = None):
    """Add the paths ``directions`` (indices into :data:`PATH_DIRECTIONS_8`)
    to ``total``, in index order; return ``(total, carry_out)``.

    ``init_carry`` / ``carry_out`` are (8, D, W): for a downward direction
    the path values of the row above the volume (in) and of its last row
    (out), for an upward one the row below (in) and the first row (out);
    zeros elsewhere. They chain row tiles exactly. This is the contract of
    the GPU kernel (``ops/sgm_cuda.py``); this is its plain reference.
    """
    cost = jnp.asarray(cost)
    if cost.dtype not in (jnp.float32, jnp.int16):
        cost = cost.astype(jnp.float32)
    D, H, W = cost.shape
    dirs = sorted(set(directions))
    directions_mask(dirs)
    acc = jnp.zeros(cost.shape, cost.dtype) if total is None \
        else jnp.asarray(total, cost.dtype)
    carry_out = jnp.zeros((8, D, W), cost.dtype)
    for i in dirs:
        dy, dx = PATH_DIRECTIONS_8[i]
        init = None if init_carry is None or dy == 0 \
            else jnp.asarray(init_carry[i], cost.dtype)
        L = aggregate_direction(cost, dy, dx, p1, p2, init)
        acc = acc + L
        if dy:
            carry_out = carry_out.at[i].set(L[:, -1] if dy > 0 else L[:, 0])
    return acc, carry_out


@functools.partial(jax.jit, static_argnames=("num_paths",))
def sgm_aggregate(cost: jnp.ndarray, p1: float, p2: float,
                  num_paths: int = 8) -> jnp.ndarray:
    """Sum of per-direction aggregations, S(p, d) = sum_r L_r(p, d).

    ``num_paths``: 8 (full), 4 (horizontal+vertical), or 2 (horizontal only
    — the cheapest option and the one whose multi-card row-sharding needs
    no halo exchange at all).
    """
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    acc_dtype = jnp.int16 if jnp.asarray(cost).dtype == jnp.int16 else jnp.float32
    total = jnp.zeros(cost.shape, acc_dtype)
    for dy, dx in PATH_DIRECTIONS_8[:num_paths]:
        total = total + aggregate_direction(cost, dy, dx, p1, p2)
    return total
