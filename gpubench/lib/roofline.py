"""The least card time a chain needs, from the bytes and operations it
must move and compute: the larger of the bytes at the card's published
peak bandwidth and the operations at its peak rate.

Each path (``paths/<path>.py``) counts its own chain's work
(``Path.work``) with bytes-minimal accounting, copied from
``tempo_tpu_torch.profiling.window_roofline`` - every input the chain
needs read once, every output it produces written once, at the widths
the card holds them (int64 timestamps, float32 values and statistics),
whatever implements the chain and however many times it re-reads.
Unlike that function, the rate it is held to is NVIDIA's published peak
of one H100 SXM (3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor
cores; both at the full 700 W power limit), not a measured stream rate.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
TS_BYTES = 8
VALUE_BYTES = 4


def least_seconds(work: dict) -> float:
    """The larger of ``work["bytes"]`` at peak bandwidth and
    ``work["flops"]`` at peak float32 rate."""
    return max(work["bytes"] / PEAK_BYTES_PER_S, work["flops"] / PEAK_FLOPS)
