"""stereo_match — a stereo depth engine in JAX for NVIDIA GPUs.

A from-scratch JAX / XLA / CUDA / Pallas framework with the capabilities of
the reference pipeline ``ocean1100/stereo_match`` (see SURVEY.md): calibrated
stereo capture ingestion (ARKit / KITTI / Middlebury), epipolar
rectification, matching-cost construction (SAD / census / Birchfield–Tomasi /
MC-CNN learned cost), semi-global matching (SGM) cost aggregation, WTA
disparity with subpixel refinement, left-right consistency, WLS edge-aware
refinement, and reprojection to colored 3-D point clouds.

Unlike the reference — which drives OpenCV's C++ kernels from single-process
Python — every numerically heavy stage here is an XLA program or a GPU
kernel (CUDA through the XLA FFI, Triton through Pallas), distributed over
device meshes with ``shard_map`` + collectives.
"""

__version__ = "0.1.0"

from stereo_match.config import DisparityConfig, load_settings  # noqa: F401
