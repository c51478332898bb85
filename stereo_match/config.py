"""Configuration for the stereo pipeline.

The parameter surface mirrors the reference's de-facto API — the
``[disparity]`` section of ``settings.ini`` merged over hard-coded defaults
(reference: ``disparity_calculation.py:75-128``, ``settings.ini:1-23``) —
plus engine knobs (cost function, dtype policy, path count) that have no
reference equivalent.
"""

from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DisparityConfig:
    """Matching parameters. Names follow the reference ``settings.ini``.

    The first block is the OpenCV-SGBM-compatible surface
    (reference ``stereo_vision/stereo_vision.py:153-163``); the second block
    is the WLS post-filter (``:172-175``); the rest are engine knobs.
    """

    # --- SGBM-compatible parameters (reference settings.ini:3-20) ---
    window_size: int = 5          # SAD window used to derive P1/P2
    min_disparity: int = 0
    num_disparities: int = 160    # must be >0; rounded up to multiple of 16
    block_size: int = 5           # matching block (odd)
    disp12_max_diff: int = 1      # LR-consistency tolerance (<0 disables)
    uniqueness_ratio: int = 15    # percent margin of best vs 2nd-best cost
    speckle_window_size: int = 0  # 0 disables speckle filtering
    speckle_range: int = 2
    pre_filter_cap: int = 63      # x-Sobel clamp for BT cost
    # --- StereoBM-compatible parameters (cv2.StereoBM defaults; the
    # reference's BM fallback `stereo_vision/stereo_vision.py:165-166`
    # passes only numDisparities/blockSize and inherits these) ---
    texture_threshold: int = 10   # min sum|sobel| over the SAD window
    bm_pre_filter_cap: int = 31   # BM's own x-Sobel clamp (cv2 default)
    # --- WLS post-filter (reference settings.ini:21-23) ---
    lmbda: float = 80000.0
    sigma: float = 1.2
    # OpenCV's DisparityWLSFilter weights the solve by an LR-consistency
    # confidence computed from the left/right matcher pair
    # (`stereo_vision/stereo_vision.py:171-183`). Off by default: on the
    # synthetic suite the validity-only confidence is equivalent away from
    # occlusions and the flag changes the filtered map's exact values
    # (tools/accuracy_eval.py measures the occlusion-scene effect).
    wls_lr_confidence: bool = False
    # --- engine knobs (no reference equivalent) ---
    cost: str = "census"          # census | sad | bt | ssd | mccnn
    census_window: tuple[int, int] = (5, 5)
    p1: float | None = None       # None -> 8 * channels * window_size**2
    p2: float | None = None       # None -> 32 * channels * window_size**2
    num_paths: int = 8            # SGM directions: 2, 4 or 8
    subpixel: bool = True         # parabola subpixel refinement
    wls: bool = True              # apply WLS refinement
    wls_iters: int = 3
    channels: int = 1             # cost channels used in P1/P2 derivation
    dtype: str = "float32"        # cost-volume storage dtype (census only).
    # int16 halves the volume's memory and is bit-exact: census costs and
    # path totals are integers. The GPU SGM kernel widens int16 to float32
    # at its boundary and narrows its result back (ops/sgm_cuda.py).

    def __post_init__(self) -> None:
        # SGBM contract: num_disparities is a positive multiple of 16.
        if self.num_disparities <= 0:
            raise ValueError("num_disparities must be > 0")
        self.num_disparities = -(-self.num_disparities // 16) * 16
        if self.dtype == "int16" and self.cost == "census":
            # int16 volumes must not wrap: each path total is bounded by
            # INVALID_COST (1024) + P2, summed over num_paths, and the
            # int16 reference sums in int16.
            bound = self.num_paths * (1024 + self.P2)
            if bound >= 2 ** 15:
                raise ValueError(
                    f"int16 cost volume would overflow: num_paths*(1024+P2)"
                    f"={bound:.0f} >= 32768; lower p2 or set dtype='float32'")

    @property
    def P1(self) -> float:
        """Small-jump penalty, scaled to the cost family's dynamic range.

        SAD/BT on 8-bit images: OpenCV's 8*ch*window^2 (reference
        ``stereo_vision/stereo_vision.py:148``). Census: the cost unit is a
        Hamming bit, so penalties scale with the descriptor bit count.
        """
        if self.p1 is not None:
            return float(self.p1)
        if self.cost in ("census", "mccnn"):
            bits = self.census_window[0] * self.census_window[1] - 1
            return bits / 3.0
        return 8.0 * self.channels * self.window_size**2

    @property
    def P2(self) -> float:
        if self.p2 is not None:
            return float(self.p2)
        if self.cost in ("census", "mccnn"):
            bits = self.census_window[0] * self.census_window[1] - 1
            return bits * 4.0
        return 32.0 * self.channels * self.window_size**2

    def replace(self, **kw: Any) -> "DisparityConfig":
        return dataclasses.replace(self, **kw)


_INT_KEYS = {
    "window_size", "min_disparity", "num_disparities", "block_size",
    "disp12_max_diff", "uniqueness_ratio", "speckle_window_size",
    "speckle_range", "pre_filter_cap", "num_paths", "wls_iters", "channels",
}
_FLOAT_KEYS = {"lmbda", "sigma", "p1", "p2"}
_BOOL_KEYS = {"subpixel", "wls"}


def load_settings(path: str | None = None,
                  overrides: dict[str, Any] | None = None) -> DisparityConfig:
    """Build a config from defaults <- INI file <- explicit overrides.

    Matches the reference's override-if-present merge semantics
    (``disparity_calculation.py:75-128``): keys absent from the INI keep
    their defaults; unknown keys are ignored.
    """
    values: dict[str, Any] = {}
    if path is not None:
        parser = configparser.ConfigParser()
        read = parser.read(path)
        if not read:
            raise FileNotFoundError(path)
        if parser.has_section("disparity"):
            section = parser["disparity"]
            for key in section:
                if key in _INT_KEYS:
                    values[key] = section.getint(key)
                elif key in _FLOAT_KEYS:
                    values[key] = section.getfloat(key)
                elif key in _BOOL_KEYS:
                    values[key] = section.getboolean(key)
                elif key in {f.name for f in dataclasses.fields(DisparityConfig)}:
                    values[key] = section.get(key)
    if overrides:
        values.update({k: v for k, v in overrides.items() if v is not None})
    known = {f.name for f in dataclasses.fields(DisparityConfig)}
    values = {k: v for k, v in values.items() if k in known}
    return DisparityConfig(**values)
