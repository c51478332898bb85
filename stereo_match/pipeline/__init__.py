from stereo_match.pipeline.stereo import (  # noqa: F401
    StereoMatcher, StereoResult, compute_disparity, run_pipeline,
)
from stereo_match.pipeline.block_matching import BlockMatcher, block_match  # noqa: F401
