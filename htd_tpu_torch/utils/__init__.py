"""Host utilities: the logger, the environment snapshot, timing,
tracing and kernel counts."""

from htd_tpu_torch.utils.logger import collect_env, get_root_logger  # noqa: F401
from htd_tpu_torch.utils.profiling import kernel_counts, profile_time, trace_to  # noqa: F401
