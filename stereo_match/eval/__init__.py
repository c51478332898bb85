from stereo_match.eval.metrics import (  # noqa: F401
    bad_pixel_rate, compare_disparities, density, end_point_error,
)
