"""Test support shipped with the port: fault injection
(:mod:`tempo_tpu_torch.testing.faults`).  The chaos campaign harness of
the reference (``testing/chaos.py``) is not ported yet."""

from tempo_tpu_torch.testing import faults  # noqa: F401

__all__ = ["faults"]
