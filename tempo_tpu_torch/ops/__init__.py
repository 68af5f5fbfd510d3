"""Packed-array operations of the port: the CUDA kernel wrappers
(``merge``, ``window``, ``stats``, ``scan``, ``bucket``), each beside its
plain PyTorch version, and the dispatchers above them.  The public ops below
are those of ``tempo_tpu/ops/__init__.py`` that the port has so far."""

from tempo_tpu_torch.ops.bucket import bucket_stats, resample_ema
from tempo_tpu_torch.ops.rolling import (
    ema_compat,
    ema_exact,
    range_window_bounds,
    segment_stats,
    shifted_row_budget,
    windowed_stats,
)
from tempo_tpu_torch.ops.scan import (
    cumsum3,
    first_valid_index_scan,
    last_valid_index_scan,
    last_valid_scan,
)
from tempo_tpu_torch.ops.window_utils import (
    first_valid_index,
    last_valid_index,
    searchsorted_batched,
    windowed_max_last,
)

__all__ = [
    "range_window_bounds",
    "windowed_stats",
    "resample_ema",
    "bucket_stats",
    "segment_stats",
    "shifted_row_budget",
    "ema_compat",
    "ema_exact",
    "last_valid_index",
    "first_valid_index",
    "windowed_max_last",
    "searchsorted_batched",
    "last_valid_scan",
    "last_valid_index_scan",
    "first_valid_index_scan",
    "cumsum3",
]
