from stereo_match.parallel.mesh import (  # noqa: F401
    batch_sharding, image_sharding, initialize_multihost, make_mesh,
    volume_sharding,
)
from stereo_match.parallel.tiling import sgm_aggregate_sharded  # noqa: F401
from stereo_match.parallel.batch import batched_matcher  # noqa: F401
from stereo_match.parallel.multihost import (  # noqa: F401
    batched_matcher_multihost, host_local_slice, load_host_sharded,
    make_host_mesh,
)
