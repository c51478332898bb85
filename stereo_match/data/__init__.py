from stereo_match.data.ply import read_ply, write_ply  # noqa: F401
from stereo_match.data.image import (  # noqa: F401
    image_read, image_save, to_grayscale,
)
from stereo_match.data.arkit import (  # noqa: F401
    ArkitFrame, build_npz, load_npz_frames, parse_session,
)
from stereo_match.data.kitti import load_kitti_pair, read_kitti_disparity  # noqa: F401
from stereo_match.data.middlebury import read_pfm, write_pfm, load_middlebury_pair  # noqa: F401
from stereo_match.data.raytrace import render_stereo  # noqa: F401
