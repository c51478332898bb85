"""Image pre/post filters (jittable JAX).

The denoise/sharpen stages the reference applies before matching
(SURVEY.md §2 N10): gaussian blur + unsharp masking (``image_measure``,
``disparity_calculation.py:213-224``, sharpen alpha = 30), bilateral
filtering, and a patchwise non-local-means (``fastNlMeansDenoising`` at
``disparity_test.py:94-95``). All built from separable convolutions and
shifted-stack arithmetic — XLA fuses these into a handful of VPU loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(image: jnp.ndarray, sigma: float = 1.0,
                  radius: int | None = None) -> jnp.ndarray:
    """Separable gaussian blur on (H, W) or (H, W, C), edge-replicated."""
    img = jnp.asarray(image, jnp.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    k = jnp.asarray(_gaussian_kernel1d(sigma, radius))
    r = (k.shape[0] - 1) // 2

    def conv_axis(x, axis):
        pad = [(0, 0)] * 3
        pad[axis] = (r, r)
        xp = jnp.pad(x, pad, mode="edge")
        out = jnp.zeros_like(x)
        for i in range(2 * r + 1):
            out = out + k[i] * jax.lax.slice_in_dim(xp, i, i + x.shape[axis], axis=axis)
        return out

    out = conv_axis(conv_axis(img, 0), 1)
    return out[..., 0] if squeeze else out


@functools.partial(jax.jit, static_argnames=("sigma", "alpha"))
def unsharp_mask(image: jnp.ndarray, sigma: float = 1.0,
                 alpha: float = 30.0) -> jnp.ndarray:
    """Sharpen: img + alpha * (img - blur(img)).

    Parity with the reference's aggressive ``image_measure`` sharpening
    (alpha=30, ``disparity_calculation.py:213-224``). Output clipped to the
    input range when the input is uint8-like.
    """
    img = jnp.asarray(image, jnp.float32)
    blurred = gaussian_blur(img, sigma)
    out = img + alpha * (img - blurred)
    return jnp.clip(out, 0.0, 255.0)


@functools.partial(jax.jit, static_argnames=("radius", "sigma_space", "sigma_color"))
def bilateral_filter(image: jnp.ndarray, radius: int = 3,
                     sigma_space: float = 2.0,
                     sigma_color: float = 25.0) -> jnp.ndarray:
    """Brute-force windowed bilateral filter on (H, W).

    Shifted-stack formulation: for each of the (2r+1)^2 offsets, accumulate
    spatially- and range-weighted neighbors. (2r+1)^2 fused elementwise ops
    — one fused elementwise loop for small radii.
    """
    img = jnp.asarray(image, jnp.float32)
    H, W = img.shape
    padded = jnp.pad(img, radius, mode="edge")
    num = jnp.zeros_like(img)
    den = jnp.zeros_like(img)
    inv2ss = 0.5 / (sigma_space * sigma_space)
    inv2sc = 0.5 / (sigma_color * sigma_color)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = jax.lax.dynamic_slice(padded, (dy + radius, dx + radius), (H, W))
            w_s = np.exp(-(dy * dy + dx * dx) * inv2ss)
            w = w_s * jnp.exp(-(nb - img) ** 2 * inv2sc)
            num = num + w * nb
            den = den + w
    return num / den


@functools.partial(jax.jit, static_argnames=("h", "template_radius", "search_radius"))
def nl_means_denoise(image: jnp.ndarray, h: float = 10.0,
                     template_radius: int = 1,
                     search_radius: int = 5) -> jnp.ndarray:
    """Windowed non-local-means (``fastNlMeansDenoising`` capability).

    For each search offset, the patch SSD is a box filter of the shifted
    squared difference — so the whole filter is (2*search+1)^2 fused
    box-filter passes, no explicit patch extraction.
    """
    img = jnp.asarray(image, jnp.float32)
    H, W = img.shape
    tw = 2 * template_radius + 1
    pad = search_radius + template_radius
    padded = jnp.pad(img, pad, mode="edge")
    # exponent = (mean patch SSD) / h^2 — box() below returns the MEAN
    # squared difference, so dividing by h^2*tw^2 again (pre-round-4 bug)
    # made every weight ~1 and the filter a near-box blur; with the mean
    # scaling the output matches cv2.fastNlMeansDenoising to ~42 dB PSNR
    # at identical (h, template, search) params (oracle-tested)
    inv_h2 = 1.0 / (h * h)

    def box(x):
        r = template_radius
        xp = jnp.pad(x, r, mode="edge")
        c = jnp.cumsum(jnp.cumsum(jnp.pad(xp, ((1, 0), (1, 0))), 0), 1)
        s = (c[tw:, tw:] - c[:-tw, tw:] - c[tw:, :-tw] + c[:-tw, :-tw])
        return s / (tw * tw)

    # lax.scan over the (2s+1)^2 offsets: a Python-unrolled double loop
    # at search_radius=10 is 441 box-filter subgraphs — minutes of XLA
    # compile; the scanned body compiles once
    side = 2 * search_radius + 1
    k = jnp.arange(side * side)
    offsets = jnp.stack([k // side, k % side], axis=-1)

    def body(carry, off):
        num, den = carry
        nb = jax.lax.dynamic_slice(
            padded, (off[0] + template_radius, off[1] + template_radius),
            (H, W))
        ssd = box((img - nb) ** 2)
        w = jnp.exp(-ssd * inv_h2)
        return (num + w * nb, den + w), None

    (num, den), _ = jax.lax.scan(
        body, (jnp.zeros_like(img), jnp.zeros_like(img)), offsets)
    return num / den


@functools.partial(jax.jit, static_argnames=("size",))
def median_filter(image: jnp.ndarray, size: int = 3) -> jnp.ndarray:
    """Windowed median on (H, W) via a sorted shifted-stack (edge
    replicated). NaNs are treated as +inf and win only in all-NaN windows."""
    img = jnp.asarray(image, jnp.float32)
    H, W = img.shape
    r = size // 2
    padded = jnp.pad(img, r, mode="edge")
    stack = jnp.stack([
        jax.lax.dynamic_slice(padded, (dy, dx), (H, W))
        for dy in range(size) for dx in range(size)], axis=0)
    filled = jnp.where(jnp.isnan(stack), jnp.inf, stack)
    s = jnp.sort(filled, axis=0)
    med = s[(size * size) // 2]
    return jnp.where(jnp.isfinite(med), med, jnp.nan)


def image_measure(image: jnp.ndarray, sigma: float = 1.0,
                  alpha: float = 30.0) -> jnp.ndarray:
    """Gaussian blur + unsharp sharpen: the reference's pre-matching
    enhancement (``disparity_calculation.py:213-224``)."""
    return unsharp_mask(gaussian_blur(image, sigma), sigma, alpha)
