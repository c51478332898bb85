from stereo_match.ops.census import census_transform, hamming_distance  # noqa: F401
from stereo_match.ops.cost_volume import (  # noqa: F401
    bt_cost_volume, build_cost_volume, census_cost_volume, sad_cost_volume,
    sobel_x_clipped,
)
from stereo_match.ops.sgm import aggregate_direction, scan_direction, sgm_aggregate  # noqa: F401
from stereo_match.ops.wta import (  # noqa: F401
    extract_disparity, from_fixed_point, to_fixed_point,
)
from stereo_match.ops.wls import fast_global_smoother, wls_filter_disparity  # noqa: F401
from stereo_match.ops.speckle import speckle_filter  # noqa: F401
from stereo_match.ops.filters import (  # noqa: F401
    bilateral_filter, gaussian_blur, image_measure, nl_means_denoise, unsharp_mask,
)
