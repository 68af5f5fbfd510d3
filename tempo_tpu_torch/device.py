"""Where the port runs and in which float type.

Every entry point takes ``device=None``, which means the CUDA card.
The CPU is used only when a caller passes ``device="cpu"`` (the tests
do): there each kernel wrapper runs its plain PyTorch version.  Asking
for CUDA on a machine without it raises; nothing drops to the CPU on
its own.

The float policy is the counterpart of ``tempo_tpu.packing.
compute_dtype``: float32 on the card (the kernels' type, as on the
TPU), float64 on the CPU (the reference's golden runs).  An explicit
``dtype`` argument wins, then ``TEMPO_TPU_COMPUTE_DTYPE``.
"""

from __future__ import annotations

from typing import Union

import torch

from tempo_tpu_torch import config

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (default ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tempo_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(device: torch.device,
                  dtype: Union[str, torch.dtype, None] = None
                  ) -> torch.dtype:
    """Float type of metric math on ``device``."""
    choice = dtype if dtype is not None else config.get(
        "TEMPO_TPU_COMPUTE_DTYPE")
    if choice is None or choice == "":
        return torch.float32 if device.type == "cuda" else torch.float64
    if isinstance(choice, torch.dtype):
        return choice
    name = str(choice).replace("torch.", "")
    if name not in ("float32", "float64"):
        raise ValueError(f"compute dtype must be float32 or float64, "
                         f"got {choice!r}")
    return getattr(torch, name)
