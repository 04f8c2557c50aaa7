"""Out-of-core streaming screener: Theorem-1 partitions straight from X.

The dense pipeline starts from a (p, p) covariance; this package starts from
the (n, p) data matrix and never materializes S — tiles of the centered Gram
stream through the fused ``kernels/covgram_screen`` kernel on the device,
compacted edges feed one union-find pass, and only the per-component
sub-blocks the solvers consume are computed.

    stream_screen          screen (X, lambda grid) out-of-core
    plan_path_streaming    screen once + plan a whole descending lambda path
    DataSession            incremental re-screen for appended data rows
    StreamConfig           tile/batch/memory-budget knobs
"""

from repro_torch.stream.config import StreamConfig, as_config
from repro_torch.stream.materialize import (
    MaterializedCovariance,
    materialize_components,
    shard_gather,
)
from repro_torch.stream.path import plan_path_from_screen, plan_path_streaming
from repro_torch.stream.screen import StreamScreen, stream_screen
from repro_torch.stream.session import DataSession, SessionUpdate

__all__ = [
    "StreamConfig",
    "as_config",
    "MaterializedCovariance",
    "materialize_components",
    "shard_gather",
    "StreamScreen",
    "stream_screen",
    "plan_path_from_screen",
    "plan_path_streaming",
    "DataSession",
    "SessionUpdate",
]
