"""Packed-array operations of the port: the CUDA kernel wrappers
(``merge``, ``window``, ``scan``, ``bucket``), each beside its plain
PyTorch version, and the dispatchers above them.  The public ops below
are those of ``tempo_tpu/ops/__init__.py`` that the port has so far."""

from tempo_tpu_torch.ops.bucket import resample_ema
from tempo_tpu_torch.ops.rolling import segment_stats
from tempo_tpu_torch.ops.scan import (
    first_valid_index_scan,
    last_valid_index_scan,
    last_valid_scan,
)
from tempo_tpu_torch.ops.window_utils import first_valid_index, last_valid_index

__all__ = [
    "resample_ema",
    "segment_stats",
    "last_valid_index",
    "first_valid_index",
    "last_valid_scan",
    "last_valid_index_scan",
    "first_valid_index_scan",
]
