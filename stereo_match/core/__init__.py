from stereo_match.core.camera import (  # noqa: F401
    arkit_to_opencv_extrinsic,
    intrinsic_from_params,
    portrait_swap_principal_point,
    relative_pose,
)
from stereo_match.core.rectify import (  # noqa: F401
    RectificationResult,
    remap_bilinear,
    rectification_maps,
    rectify_pair,
    stereo_rectify,
)
from stereo_match.core.reproject import (  # noqa: F401
    depth_to_points,
    disparity_to_depth,
    make_q_matrix,
    pinhole_backproject,
    reproject_image_to_3d,
)
