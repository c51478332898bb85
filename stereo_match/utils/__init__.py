from stereo_match.utils import handy  # noqa: F401
from stereo_match.utils.profiling import StageTimer, trace_stage  # noqa: F401
