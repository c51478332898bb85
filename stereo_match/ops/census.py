"""Census transform and Hamming distance (jittable JAX).

The default matching cost (SURVEY.md §2 N2): census is a bit-packed local
rank descriptor, robust to radiometric differences, and its Hamming-distance
cost is cheap integer work (xor + ``lax.population_count``), which XLA fuses
with the compares into one loop. The reference gets its pixel cost
implicitly from OpenCV SGBM's Birchfield–Tomasi (see ``cost_volume.bt_cost``
for that variant).

Windows larger than 32 pixels are packed into multiple int32 words.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def census_transform(image: jnp.ndarray, window: tuple[int, int] = (5, 5)) -> jnp.ndarray:
    """Census descriptor per pixel, packed into int32 words.

    ``image``: (H, W) float or uint8. Returns (H, W, n_words) int32 where
    bit k of word w is 1 when the k-th neighbor (row-major order over the
    window, center excluded) is strictly darker than the center pixel.
    Borders compare against edge-replicated pixels.
    """
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError("census window must be odd in both dimensions")
    img = jnp.asarray(image, jnp.float32)
    H, W = img.shape
    ry, rx = wh // 2, ww // 2
    padded = jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")

    n_bits = wh * ww - 1
    n_words = (n_bits + 31) // 32
    words = [jnp.zeros((H, W), jnp.int32) for _ in range(n_words)]
    bit = 0
    for dy in range(wh):
        for dx in range(ww):
            if dy == ry and dx == rx:
                continue
            neighbor = jax.lax.dynamic_slice(padded, (dy, dx), (H, W))
            b = (neighbor < img).astype(jnp.int32)
            words[bit // 32] = words[bit // 32] | (b << (bit % 32))
            bit += 1
    return jnp.stack(words, axis=-1)


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Popcount(xor) summed over descriptor words; shapes broadcast."""
    x = jax.lax.population_count(jnp.bitwise_xor(a, b))
    return jnp.sum(x.astype(jnp.int32), axis=-1)
