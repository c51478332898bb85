"""External raw cost-volume ingestion (the MC-CNN ``left.bin`` contract).

The reference's only inter-process hand-off (SURVEY.md §3.5): the external
MC-CNN tool dumps a float32 cost volume as ``left.bin`` with shape
(1, disp_max, W, H) which ``mapTo3D_mc_cnn.py:71`` memmaps. This module
reads/writes that contract and converts to the framework's (D, H, W)
planes layout, so externally-computed costs (any tool) can feed the SGM /
WLS / reprojection stages.
"""

from __future__ import annotations

import numpy as np


def read_cost_bin(path: str, disp_max: int, width: int, height: int,
                  mmap: bool = True) -> np.ndarray:
    """Read an external (1, D, W, H) float32 dump -> (D, H, W) volume."""
    shape = (1, disp_max, width, height)
    if mmap:
        raw = np.memmap(path, dtype=np.float32, mode="r", shape=shape)
    else:
        raw = np.fromfile(path, dtype=np.float32).reshape(shape)
    return np.ascontiguousarray(np.transpose(raw[0], (0, 2, 1)))


def write_cost_bin(path: str, volume: np.ndarray) -> None:
    """Write a (D, H, W) volume in the external (1, D, W, H) contract."""
    vol = np.asarray(volume, np.float32)
    out = np.transpose(vol, (0, 2, 1))[None]
    out.astype("<f4").tofile(path)


def external_volume_to_disparity(volume: np.ndarray, p1: float = 8.0,
                                 p2: float = 96.0, num_paths: int = 8,
                                 guide=None, lmbda: float = 8000.0,
                                 sigma: float = 1.2):
    """Aggregate + extract + (optionally) WLS-refine an external volume.

    Capability parity with ``mapTo3D_mc_cnn.py:68-105`` where the external
    disparities are WLS-filtered before reprojection.
    """
    import jax.numpy as jnp
    from stereo_match.ops.sgm import sgm_aggregate
    from stereo_match.ops.wls import wls_filter_disparity
    from stereo_match.ops.wta import extract_disparity
    vol = jnp.asarray(volume, jnp.float32)
    agg = sgm_aggregate(vol, p1, p2, num_paths)
    disp = extract_disparity(agg, uniqueness_ratio=0, disp12_max_diff=1)
    if guide is not None:
        disp = wls_filter_disparity(disp, jnp.asarray(guide, jnp.float32),
                                    lmbda=lmbda, sigma_color=sigma)
    return np.asarray(disp)
