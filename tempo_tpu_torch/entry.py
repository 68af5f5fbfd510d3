"""The flagship step as one program over packed tensors.

Counterpart of ``__graft_entry__._forward_step``: an AS-OF join
(skipNulls=True) of the right columns onto the left rows, then
withRangeStats over a 10 s range window on the left metric, then exact
EMA, with the same outputs dict.  Shapes: ``l_ts``/``l_secs``/``x``/
``valid`` [K, Ll]; ``r_ts`` [K, Lr]; ``r_valids``/``r_values``
[N_RIGHT_COLS, K, Lr].  CUDA tensors run the three kernels, CPU tensors
their plain versions.  ``interop.from_reference_arrays`` turns the
reference's numpy inputs into these tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tempo_tpu_torch.ops import scan, window
from tempo_tpu_torch.ops import sortmerge as sm

N_RIGHT_COLS = 2
WINDOW_SECS = 10.0
# static row bounds of the 10 s window over data ticking every 1-2 s;
# the kernel's clipped audit reports any frame that reaches past them
MAX_WINDOW_ROWS = 20
MAX_TIE_ROWS = 8
EMA_ALPHA = 0.2


def forward_step(l_ts, l_secs, x, valid, r_ts, r_valids, r_values
                 ) -> Dict[str, torch.Tensor]:
    joined, found, last_idx = sm.asof_merge_values(l_ts, r_ts, r_valids,
                                                   r_values)
    stats = window.range_stats(l_secs.to(torch.int32), x, valid,
                               int(WINDOW_SECS), MAX_WINDOW_ROWS,
                               MAX_TIE_ROWS)
    ema = scan.ema(x, valid, EMA_ALPHA)
    out = {f"stats_{k}": v for k, v in stats.items()}
    out.update({"joined": joined, "ema": ema, "last_right_row": last_idx})
    return out


def example_args(K=8, Ll=128, Lr=128, seed=0):
    """The reference's ``_example_args`` inputs (numpy, same seed)."""
    rng = np.random.default_rng(seed)
    secs = np.sort(rng.integers(0, 4 * Ll, size=(K, Ll)), axis=-1)
    l_secs = secs.astype(np.int64)
    l_ts = l_secs * np.int64(1_000_000_000)
    r_secs = np.sort(rng.integers(0, 4 * Lr, size=(K, Lr)), axis=-1)
    r_ts = r_secs.astype(np.int64) * np.int64(1_000_000_000)
    x = rng.standard_normal((K, Ll)).astype(np.float32)
    valid = np.ones((K, Ll), dtype=bool)
    r_values = rng.standard_normal((N_RIGHT_COLS, K, Lr)).astype(np.float32)
    r_valids = rng.random((N_RIGHT_COLS, K, Lr)) > 0.1
    return (l_ts, l_secs, x, valid, r_ts, r_valids, r_values)
