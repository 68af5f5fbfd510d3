"""tempo_tpu_torch: the PyTorch / CUDA port of tempo_tpu.

The ``TSDF``: the flagship chain (pandas in -> ``TSDF`` -> ``asofJoin``
-> ``withRangeStats`` -> exact ``EMA`` -> pandas out), the resample
family, grouped stats, vwap, lookback features, the spectral ops,
describe, the DataFrame-mirror ops and SQL; and, through
``TSDF.on_mesh``, the ``DistributedTSDF`` that chains those ops on the
devices of a mesh (``make_mesh``), cut over its series axis and, with a
time axis, over time blocks (``parallel``: halo exchange, layout
switches, several processes over ``torch.distributed``).  Its kernels
run on a CUDA card, hand-written (``ops/merge.py``, ``ops/window.py``,
``ops/stats.py``, ``ops/scan.py``, ``ops/bucket.py``); ``device="cpu"``
runs their plain PyTorch versions.
This package imports neither JAX nor ``tempo_tpu``.
"""

from tempo_tpu_torch.dist import DistributedTSDF
from tempo_tpu_torch.frame import TSDF
from tempo_tpu_torch.parallel import make_mesh

__all__ = ["TSDF", "DistributedTSDF", "make_mesh"]
