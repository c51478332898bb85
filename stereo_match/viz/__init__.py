from stereo_match.viz.plots import (  # noqa: F401
    axis_equal_3d, colorize_disparity, plot_camera, plot_transforms,
    show_disparity, show_image_pair,
)
