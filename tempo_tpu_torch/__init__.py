"""tempo_tpu_torch: the PyTorch / CUDA port of tempo_tpu.

The flagship chain (pandas in -> ``TSDF`` -> ``asofJoin`` ->
``withRangeStats`` -> exact ``EMA`` -> pandas out) and the resample
family (``resample``, ``calc_bars``, ``resampleEMA``, ``interpolate``)
run on a CUDA card through hand-written kernels (``ops/merge.py``,
``ops/window.py``, ``ops/scan.py``, ``ops/bucket.py``); ``device="cpu"``
runs their plain PyTorch versions.
This package imports neither JAX nor ``tempo_tpu``.
"""

from tempo_tpu_torch.frame import TSDF

__all__ = ["TSDF"]
