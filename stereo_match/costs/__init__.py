"""Cost providers: one interface over every matching-cost family.

The reference wires each cost source differently (OpenCV SGBM's built-in BT
cost, an external MC-CNN process writing ``left.bin``, libelas' descriptor
cost). Here they are all callables ``(left, right) -> (D, H, W) volume``
feeding the same SGM aggregation (SURVEY.md §7 ``costs/`` layer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Protocol

import jax.numpy as jnp

from stereo_match.config import DisparityConfig
from stereo_match.ops.cost_volume import build_cost_volume


class CostProvider(Protocol):
    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
        """Grayscale pair -> (D, H, W) cost volume."""


@dataclass(frozen=True)
class ClassicCost:
    """census | sad | ssd | bt via ``ops.cost_volume`` (static dispatch)."""
    config: DisparityConfig

    def __call__(self, left, right):
        c = self.config
        return build_cost_volume(
            left, right, num_disparities=c.num_disparities,
            min_disparity=c.min_disparity, cost=c.cost,
            block_size=c.block_size, window=c.census_window,
            pre_filter_cap=c.pre_filter_cap)


@dataclass(frozen=True)
class MCCNNCost:
    """Learned cost from a trained MC-CNN tower (SURVEY.md §2 N8)."""
    model: Any
    params: Any
    config: DisparityConfig
    scale: float = 24.0

    def __call__(self, left, right):
        from stereo_match.models.mccnn import mccnn_cost_volume
        c = self.config
        return mccnn_cost_volume(self.model, self.params, left, right,
                                 num_disparities=c.num_disparities,
                                 min_disparity=c.min_disparity,
                                 scale=self.scale)


def make_cost_provider(config: DisparityConfig,
                       model: Any = None, params: Any = None) -> Callable:
    if config.cost == "mccnn":
        if model is None or params is None:
            raise ValueError("cost='mccnn' needs model and params")
        return MCCNNCost(model, params, config)
    return ClassicCost(config)
