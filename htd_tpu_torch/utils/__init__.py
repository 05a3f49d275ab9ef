"""Host utilities: the logger, the environment snapshot, timing and
tracing."""

from htd_tpu_torch.utils.logger import collect_env, get_root_logger  # noqa: F401
from htd_tpu_torch.utils.profiling import profile_time, trace_to  # noqa: F401
