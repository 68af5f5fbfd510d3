"""The state that crosses between the reference and the port.

The system has no weights: what crosses is the packed input state, the
numpy arrays that the reference's packers and ``_example_args`` produce
([K, L] int64 timestamps, float metric planes, bool validity planes,
[C, K, L] right-side stacks).  :func:`from_reference_arrays` makes the
port's tensors from them with the same dtypes and layout, and
:func:`to_numpy` brings the port's outputs back for comparison.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tempo_tpu_torch import device as devices


def from_reference_arrays(*arrays: np.ndarray,
                          device: devices.DeviceLike = None
                          ) -> Tuple[torch.Tensor, ...]:
    """Each numpy array as a contiguous tensor of the same dtype and
    shape on ``device`` (default CUDA)."""
    dev = devices.resolve(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A dict of the port's tensors as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}

